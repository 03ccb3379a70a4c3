"""The port's selective scan held against the JAX reference.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, as tests/test_kernels.py runs it on the CPU) and its ``ssm_scan_ref``,
and through the port's ``ops.selective_scan``, which on CPU tensors runs the
kernel's plain torch version. Both run the same f32 recurrence, so f32 is
held to 1e-5 of ``max|ref|``; bf16 to the reference's numerics gate, 3e-2
(``_DEFAULT_TOL``, ``core/kernel_tune.py``). The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_kernel_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernel_tune import KERNEL_SPACES as REF_SPACES
from repro.kernels.ssm_scan import ops as jax_ops
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ref
from repro_torch.core.kernel_tune import KERNEL_SPACES
from repro_torch.kernels import ssm_shape_class
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(seed, b, s, di, n, dtype):
    """Seeded numpy Δ (softplus), u, B, C, A = -exp(0.3·z), the reference
    tuner's distributions, handed to both frameworks in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [np.log1p(np.exp(rng.standard_normal((b, s, di), dtype=np.float32))),
            rng.standard_normal((b, s, di), dtype=np.float32),
            rng.standard_normal((b, s, n), dtype=np.float32),
            rng.standard_normal((b, s, n), dtype=np.float32),
            -np.exp(0.3 * rng.standard_normal((di, n), dtype=np.float32))]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, th


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(x, dtype=np.float32)


def _rel(port, ref) -> float:
    """``max|a-b| / max|ref|``, the reference's numerics-gate metric."""
    a, r = _f32(port), _f32(ref)
    return float(np.abs(a - r).max() / np.abs(r).max())


# (b, s, di, n, chunk, d_block): tests/test_kernels.py's ssm shapes —
# S 100 with d_block 1024 > di 48 (the space's edge), and the sweep's
CASES = [
    (1, 100, 48, 8, 16, 1024),
    (1, 100, 48, 8, 256, 16),
    (2, 100, 64, 8, 32, 32),
    (2, 100, 64, 8, 64, 16),
    (1, 64, 32, 16, 32, 32),
    (1, 64, 32, 16, 64, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,n,chunk,d_block", CASES)
def test_selective_scan_matches_reference(dtype, b, s, di, n, chunk, d_block):
    jx, th = _inputs(3, b, s, di, n, dtype)
    port = ops.selective_scan(*th, chunk=chunk, d_block=d_block)
    assert port.dtype == getattr(torch, dtype) and port.shape == (b, s, di)
    kernel = jax_ops.selective_scan(*jx, chunk=chunk, d_block=d_block, interpret=True)
    ref = jax_ref(*jx)
    assert _rel(port, kernel) < TOL[dtype]
    assert _rel(port, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_oracle_matches_reference_oracle(dtype):
    jx, th = _inputs(4, 2, 100, 64, 8, dtype)
    assert _rel(ssm_scan_ref(*th), jax_ref(*jx)) < TOL[dtype]
    assert ssm_scan_ref(*th).dtype == getattr(torch, dtype)


def test_plain_version_matches_oracle_at_f32():
    """The plain version (the kernel's own summation order) and the oracle
    (einsum) run one recurrence: f32 agreement to a few ulps of max|y|."""
    _, th = _inputs(5, 2, 100, 48, 16, "float32")
    assert _rel(ssm_kernel.ssm_scan_plain(*th), ssm_scan_ref(*th)) < 1e-6


def test_snaps_equal_the_references_over_the_space():
    """The snaps decide which proposals alias, so the tuner's aliases are
    the reference's: compare at every pow2 value of both knobs' ranges (and
    beyond them) against sequence lengths and channel dims of every kind."""
    for chunk in [1, 3, 7, 16, 32, 64, 100, 128, 256, 512, 1024]:
        for seq in [1, 5, 16, 100, 128, 129, 4096]:
            assert ops.snap_chunk(chunk, seq) == jax_ops.snap_chunk(chunk, seq)
            assert ops.snap_chunk(ops.snap_chunk(chunk, seq), seq) == ops.snap_chunk(chunk, seq)
    for d_block in [1, 2, 16, 32, 48, 64, 96, 128, 256, 512, 1024, 2048]:
        for di in [1, 3, 48, 64, 96, 100, 160, 200, 256, 16384]:
            assert ops.snap_d_block(d_block, di) == jax_ops.snap_d_block(d_block, di)
            snapped = ops.snap_d_block(d_block, di)
            assert di % snapped == 0 and ops.snap_d_block(snapped, di) == snapped


def test_space_is_the_references():
    port, ref = KERNEL_SPACES["ssm_scan"], REF_SPACES["ssm_scan"]
    assert port.names() == ref.names()
    for p, r in zip(port.params, ref.params):
        assert (p.name, p.default, p.lo, p.hi, p.pow2) == (r.name, r.default, r.lo, r.hi, r.pow2)
        assert p.grid(100) == r.grid(100)


@pytest.mark.parametrize("n", ssm_kernel.STATE_DIMS)
def test_smem_footprint_fits_at_every_point(n):
    """Every point of the Hopper space is a legal launch at every compiled
    N: d_block is at most the block's 1024 threads, and B and C staged for
    ``chunk`` steps fit the 232,448 B a block may opt into."""
    space = KERNEL_SPACES["ssm_scan"]
    chunks = space.params[0].grid(100)
    d_blocks = space.params[1].grid(100)
    assert max(d_blocks) <= ssm_kernel.MAX_D_BLOCK
    for chunk in chunks:
        assert ops.smem_footprint(chunk, n) <= ops.SMEM_LIMIT == 232448
        assert ops.smem_footprint(chunk, n) == 2 * chunk * n * 4


def test_footprint_is_monotone_in_chunk():
    sizes = [ops.smem_footprint(c, 16) for c in (16, 32, 64, 128, 256)]
    assert sizes == sorted(sizes) and len(set(sizes)) == len(sizes)


def test_cpu_call_never_builds(monkeypatch):
    """A CPU tensor goes to the plain version: nvcc and ctypes are never
    reached, and no launch is counted."""
    from repro_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "library", boom)
    monkeypatch.setattr(_build, "build_all", boom)
    _, th = _inputs(6, 1, 20, 16, 4, "float32")
    before = ssm_kernel.LAUNCHES
    y = ops.selective_scan(*th)
    assert y.shape == (1, 20, 16) and ssm_kernel.LAUNCHES == before


def test_tuned_table_fills_missing_knobs(monkeypatch, tmp_path):
    """With no knobs, ops reads the port's own table (the environment
    variable points at it), exact class first, then snaps the entry."""
    import json

    from repro_torch import kernels

    b, s, di, n = 1, 40, 48, 8
    table = tmp_path / "table.json"
    key = kernels.table_key("ssm_scan", "f32", ssm_shape_class((b, s, di), n))
    table.write_text(json.dumps({"version": 1, "entries": {
        key: {"config": {"chunk": 64, "d_block": 32}}}}))
    monkeypatch.setenv(kernels.TUNED_TABLE_ENV, str(table))
    kernels.invalidate_tuned_table_cache()
    seen = {}

    def spy(*args, chunk, d_block):
        seen.update(chunk=chunk, d_block=d_block)
        return ssm_kernel.ssm_scan_plain(*args)

    monkeypatch.setattr(ops, "ssm_scan", spy)
    _, th = _inputs(7, b, s, di, n, "float32")
    ops.selective_scan(*th)
    # chunk 64 clamps to S=40; d_block 32 halves to 16, which divides 48
    assert seen == {"chunk": 40, "d_block": 16}
    ops.selective_scan(*th, chunk=8, d_block=48)
    assert seen == {"chunk": 8, "d_block": 48}
    kernels.invalidate_tuned_table_cache()


@pytest.mark.parametrize("bad,match", [
    (dict(n=5), "state sizes"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d_block=2048), "d_block"),
    (dict(chunk=1024, n=64), "shared memory"),
])
def test_kernel_checks_raise(bad, match):
    """What the CUDA kernel does not take raises in the wrapper's checks
    (which run before any build)."""
    n = bad.get("n", 8)
    dtype = bad.get("dtype", torch.float32)
    x = [torch.zeros(1, 4, 8, dtype=dtype), torch.zeros(1, 4, 8, dtype=dtype),
         torch.zeros(1, 4, n, dtype=dtype), torch.zeros(1, 4, n, dtype=dtype),
         torch.zeros(8, n, dtype=dtype)]
    with pytest.raises(ValueError, match=match):
        ssm_kernel._check(*x, bad.get("chunk", 16), bad.get("d_block", 32))


def test_non_cuda_device_raises():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no selective-scan path"):
        ssm_kernel.ssm_scan(x, x, torch.zeros(1, 4, 8, device="meta"),
                            torch.zeros(1, 4, 8, device="meta"),
                            torch.zeros(8, 8, device="meta"))
