"""The CUDA kernels (flash attention, selective scan) held against their plain
torch versions on the card.

This file imports neither JAX nor the reference package, so it runs where
only the port is installed: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_kernel_card.py``. Without a CUDA device every test skips.

Kernel and plain version both do f32 math and differ only in summation order
and exp/tanh rounding, so they are held element-wise, ``|a-b| <= rtol*|plain|
+ atol``: at bf16 one rounding step of the output (at most 2^-7 of it), at
f32 a few ulps. The bound holds for scores of the size the model gives the
kernel: it pre-scales q by dh^-0.5, so scores are O(1). With an unscaled
N(0,1) q the scores reach tens, their f32 rounding grows with them, and the
f32 case exceeds the bound on the H100.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops

CARD_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0**-7, 1e-6)}


def _inputs(seed, b, s, hq, hkv, dh, dtype):
    """q (pre-scaled by dh^-0.5, as the model passes it), k, v on the card."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
    arrs[0] *= dh**-0.5
    return [torch.from_numpy(a).to(getattr(torch, dtype)).cuda() for a in arrs]


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("float32", "bfloat16"):
        # a windowed, softcapped ragged case and a causal one deep enough that
        # late query tiles read many KV tiles
        for s, window, cap in ((200, 64, 30.0), (1024, 0, 0.0)):
            tq, tk, tv = _inputs(5, 2, s, 8, 2, 64, dtype)
            before = fa_kernel.LAUNCHES
            out = ops.flash_attention(tq, tk, tv, window=window, softcap_val=cap)
            assert fa_kernel.LAUNCHES == before + 1
            plain = fa_kernel.flash_attention_plain(tq, tk, tv, window=window,
                                                    softcap=cap, scale=1.0)
            rtol, atol = CARD_TOL[dtype]
            a, r = out.float(), plain.float()
            assert ((a - r).abs() <= rtol * r.abs() + atol).all(), (dtype, s)


@pytest.mark.gpu
def test_ssm_kernel_matches_plain_on_gpu():
    """The selective-scan kernel against its plain version: a ragged last
    chunk, d_block above di, and a chunk past the 48 KB shared-memory
    default, at both dtypes and every compiled N."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    rng = np.random.default_rng(7)
    for n, (chunk, d_block) in zip(ssm_kernel.STATE_DIMS,
                                   ((64, 32), (16, 1024), (128, 96), (256, 64), (256, 128))):
        for dtype in ("float32", "bfloat16"):
            b, s, di = 2, 300, 160
            arrs = [np.log1p(np.exp(rng.standard_normal((b, s, di), dtype=np.float32))),
                    rng.standard_normal((b, s, di), dtype=np.float32),
                    rng.standard_normal((b, s, n), dtype=np.float32),
                    rng.standard_normal((b, s, n), dtype=np.float32),
                    -np.exp(0.3 * rng.standard_normal((di, n), dtype=np.float32))]
            x = [torch.from_numpy(a).to(getattr(torch, dtype)).cuda() for a in arrs]
            before = ssm_kernel.LAUNCHES
            out = ssm_kernel.ssm_scan(*x, chunk=chunk, d_block=d_block)
            assert ssm_kernel.LAUNCHES == before + 1
            plain = ssm_kernel.ssm_scan_plain(*x)
            rtol, atol = CARD_TOL[dtype]
            a, r = out.float(), plain.float()
            assert ((a - r).abs() <= rtol * r.abs() + atol).all(), (n, dtype)
            # through ops: d_block snapped to a divisor of di, chunk to S
            out = ssm_ops.selective_scan(*x, chunk=chunk, d_block=d_block)
            assert ((out.float() - r).abs() <= rtol * r.abs() + atol).all(), (n, dtype)
