"""The port's flash attention held against the JAX reference.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, as tests/test_kernels.py runs it on the CPU) and its ``attention_ref``,
and through the port's ``ops.flash_attention``, which on CPU tensors runs the
kernel's plain torch version. Tolerances are the reference's numerics gate
(``core/kernel_tune.py``): ``max|a-b| / max|ref|`` below 1e-4 at f32 and
3e-2 at bf16. The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py`` and by ``tests/test_torch_kernel_card.py``.
"""
import ctypes
import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(seed, b, s, hq, hkv, dh, dtype, t=None):
    """Seeded numpy q/k/v handed to both frameworks in ``dtype``."""
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))]
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


# (b, s, hq, hkv, dh, causal, window, softcap, block_q, block_kv, kv_length)
CASES = [
    (2, 256, 4, 2, 64, True, 0, 0.0, 128, 128, None),   # GQA g=2
    (1, 384, 4, 1, 128, True, 128, 50.0, 128, 128, None),  # window + softcap, g=4
    (2, 256, 8, 8, 64, False, 0, 0.0, 128, 256, None),  # full, g=1
    (1, 200, 4, 2, 64, True, 0, 0.0, 128, 128, None),   # ragged S
    (1, 512, 2, 2, 64, True, 0, 0.0, 256, 128, None),   # asymmetric tiles
    (1, 256, 4, 2, 64, True, 0, 0.0, 128, 128, 180),    # kv_length, causal
    (2, 160, 4, 4, 32, False, 0, 0.0, 128, 128, 100),   # kv_length, full
    (1, 256, 2, 1, 256, True, 0, 0.0, 128, 128, None),  # dh 256
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window,cap,bq,bkv,kv_len", CASES)
def test_flash_matches_pallas_and_ref(dtype, b, s, hq, hkv, dh, causal, window,
                                      cap, bq, bkv, kv_len):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, b, s, hq, hkv, dh, dtype)
    scale = dh**-0.5
    # the model pre-scales q in its compute dtype and calls with scale=1.0
    jqs, tqs = (jq * scale).astype(jq.dtype), (tq * scale).to(tq.dtype)
    kw = dict(causal=causal, window=window, kv_length=kv_len)
    out = ops.flash_attention(tqs, tk, tv, softcap_val=cap, block_q=bq,
                              block_kv=bkv, **kw)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    pallas = jax_flash(jqs, jk, jv, softcap_val=cap, block_q=bq, block_kv=bkv,
                       interpret=True, **kw)
    ref = jax_ref(jqs, jk, jv, softcap=cap, scale=1.0, **kw)
    assert _rel(out, pallas) < TOL[dtype]
    assert _rel(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window,cap,kv_len", [
    (2, 96, 4, 2, 64, True, 0, 0.0, None),
    (1, 80, 4, 1, 32, True, 16, 30.0, None),
    (2, 64, 2, 2, 16, False, 0, 0.0, 40),
])
def test_attention_ref_matches_reference_oracle(dtype, b, s, hq, hkv, dh, causal,
                                                window, cap, kv_len):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, b, s, hq, hkv, dh, dtype)
    kw = dict(causal=causal, window=window, softcap=cap, kv_length=kv_len)
    out = attention_ref(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype
    assert _rel(out, jax_ref(jq, jk, jv, **kw)) < TOL[dtype]


def test_plain_version_matches_oracle_at_kernel_tiles():
    """The plain version at each tile pair the kernel is compiled for (the
    CPU stand-in for every tiling the card runs), f32."""
    _, (tq, tk, tv) = _inputs(2, 1, 150, 4, 2, 64, "float32")
    ref = attention_ref(tq, tk, tv, window=40)
    for bq in fa_kernel.TILES:
        for bkv in fa_kernel.TILES:
            out = fa_kernel.flash_attention_plain(tq, tk, tv, window=40,
                                                  block_q=bq, block_kv=bkv)
            assert _rel(out, ref) < TOL["float32"], (bq, bkv)


# ------------------------------------------------------------------ routing


def test_rejects_decode_step():
    q = torch.zeros((1, 1, 2, 64))
    with pytest.raises(ValueError, match="decode"):
        ops.flash_attention(q, q, q)


def test_rejects_tensor_window():
    q = torch.zeros((1, 64, 2, 64))
    with pytest.raises(ValueError, match="static window"):
        ops.flash_attention(q, q, q, window=torch.tensor(8))


def test_rejects_tensor_kv_length():
    q = torch.zeros((1, 64, 2, 64))
    with pytest.raises(ValueError, match="kv_length"):
        ops.flash_attention(q, q, q, kv_length=torch.tensor([32]))


def test_q_positions_is_ignored():
    _, (tq, tk, tv) = _inputs(3, 1, 64, 2, 2, 32, "float32")
    a = ops.flash_attention(tq, tk, tv)
    b = ops.flash_attention(tq, tk, tv, q_positions=torch.full((1, 64), 7))
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [
    dict(dtype=torch.float16),
    dict(dh=48),
    dict(block_q=128),
    dict(block_kv=16),
    dict(transpose=True),
    dict(kv_length=65),
])
def test_kernel_wrapper_validates_inputs(bad):
    """What the kernel does not take raises before any launch."""
    dh = bad.get("dh", 64)
    q = torch.zeros((1, 64, 2, dh), dtype=bad.get("dtype", torch.float32))
    k = torch.zeros((1, 64, 1, dh), dtype=q.dtype)
    if bad.get("transpose"):
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fa_kernel._check(q, k, k, bad.get("block_q", 64), bad.get("block_kv", 64),
                         bad.get("kv_length"))


# ------------------------------------------------------------- tuned table


def _table(path, block):
    entry = {"config": {"block_q": block, "block_kv": block}}
    path.write_text(json.dumps({"version": 1, "entries": {
        "flash_attention|f32|b1s128h2k2d64": entry}}))
    return path


@pytest.fixture
def blocks_seen(monkeypatch):
    seen = []

    def spy(q, k, v, **kw):
        seen.append((kw["block_q"], kw["block_kv"]))
        return q
    monkeypatch.setattr(ops, "flash_attention_fwd", spy)
    return seen


def test_tuned_table_is_the_ports_own(tmp_path, monkeypatch, blocks_seen):
    """Blocks come from the port's table when the caller passes none; a table
    set for the reference (its file, its variable) is never read."""
    import repro.kernels as jax_kernels
    import repro_torch.kernels as port_kernels

    assert port_kernels.DEFAULT_TABLE_PATH != jax_kernels.DEFAULT_TABLE_PATH
    assert port_kernels.TUNED_TABLE_ENV != jax_kernels.TUNED_TABLE_ENV
    q = torch.zeros((1, 128, 2, 64))
    monkeypatch.setenv(jax_kernels.TUNED_TABLE_ENV, str(_table(tmp_path / "tpu.json", 32)))
    monkeypatch.delenv(port_kernels.TUNED_TABLE_ENV, raising=False)
    ops.flash_attention(q, q, q)
    monkeypatch.setenv(port_kernels.TUNED_TABLE_ENV, str(_table(tmp_path / "h100.json", 32)))
    ops.flash_attention(q, q, q)
    ops.flash_attention(q, q, q, block_kv=2048)  # an explicit knob wins, snapped
    assert blocks_seen == [(64, 64), (32, 32), (32, 64)]


# ------------------------------------------------------------ tiles and smem

GRID = range(128, 2049, 128)  # the reference's attn_block_q/kv knob grid


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snap_block_is_idempotent_and_legal(dh, dtype):
    for seq in (1, 17, 64, 200, 2048, 32768):
        for block in list(range(1, 300, 7)) + list(GRID):
            snapped = ops.snap_block(block, seq, dh, dtype)
            assert snapped in fa_kernel.TILES
            assert ops.snap_block(snapped, seq, dh, dtype) == snapped


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snapped_grid_fits_shared_memory(dh, dtype):
    nbytes = torch.empty((), dtype=dtype).element_size()
    for seq in (200, 2048, 32768):
        for bq in GRID:
            for bkv in GRID:
                fp = ops.smem_footprint(ops.snap_block(bq, seq, dh, dtype),
                                        ops.snap_block(bkv, seq, dh, dtype),
                                        dh, nbytes)
                assert fp <= ops.SMEM_LIMIT == 232448


def test_smem_footprint_matches_kernel_layout():
    # q (64 x 65) + K^T (64 x 65) + V (64 x 64) + P (64 x 65) floats at dh 64
    assert ops.smem_footprint(64, 64, 64, 2) == 4 * (64 * 65 * 3 + 64 * 64)


# ------------------------------------------------------------- no build on CPU


def test_cpu_path_never_builds_or_loads(monkeypatch):
    from repro_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(ctypes, "CDLL", boom)
    monkeypatch.setattr(subprocess, "Popen", boom)
    monkeypatch.setattr(_build, "library", boom)
    before = fa_kernel.LAUNCHES
    _, (tq, tk, tv) = _inputs(4, 1, 100, 4, 2, 64, "bfloat16")
    out = ops.flash_attention(tq, tk, tv, window=32, softcap_val=20.0)
    assert torch.isfinite(out.float()).all()
    assert fa_kernel.LAUNCHES == before  # the plain version is not a launch
