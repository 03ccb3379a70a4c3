"""The model's attention paths against the naive oracle, as
tests/test_attention.py holds the reference's, and the port's oracle against
the reference's. Inputs come from ``numpy.random.default_rng``. The paths
are held element-wise, as the reference's own attention test does: f32
within 2e-5, bf16 within 2e-2 (the torch path rounds its probabilities to
bf16 before the PV product, the oracle rounds them once after the softmax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_reference as jax_attention_reference
from repro_torch.models.attention import attention, attention_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, s, hq, hkv, dh, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    return th + [torch.from_numpy(pos.copy())], jx + [jnp.asarray(pos)]


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


CASES = [  # (b, s, hq, hkv, dh, window, cap)
    (2, 128, 4, 2, 32, 0, 0.0),
    (1, 257, 4, 1, 64, 0, 0.0),     # odd length: padded block tail
    (2, 192, 8, 8, 32, 64, 0.0),    # sliding window (MHA)
    (1, 128, 4, 2, 32, 0, 30.0),    # logit softcap
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["blockwise", "single_shot", "kernel"])
@pytest.mark.parametrize("b,s,hq,hkv,dh,window,cap", CASES)
def test_attention_paths_match_oracle(path, dtype, b, s, hq, hkv, dh, window, cap):
    """Each path of ``attention`` against ``attention_reference``: the
    blockwise online softmax (block_kv < S), the single-shot softmax
    (block_kv >= S) and the kernel impl (on CPU tensors, its plain version)."""
    (q, k, v, pos), _ = _inputs(0, b, s, hq, hkv, dh, dtype)
    impl = "kernel" if path == "kernel" else "torch"
    block_kv = 64 if path == "blockwise" else 512
    out = attention(q, k, v, q_positions=pos, window=window, softcap_val=cap,
                    block_kv=block_kv, impl=impl)
    ref = attention_reference(q, k, v, q_positions=pos, window=window, softcap_val=cap)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _maxdiff(_np(out), _np(ref)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,dh,window,cap", CASES)
def test_oracle_matches_reference_oracle(dtype, b, s, hq, hkv, dh, window, cap):
    (q, k, v, pos), (jq, jk, jv, jpos) = _inputs(1, b, s, hq, hkv, dh, dtype)
    out = attention_reference(q, k, v, q_positions=pos, window=window, softcap_val=cap)
    ref = jax_attention_reference(jq, jk, jv, q_positions=jpos, window=window,
                                  softcap_val=cap)
    assert _maxdiff(_np(out), _np(ref)) < TOL[dtype]


def test_oracle_masks_kv_length_and_tensor_window():
    """A decode query against a partly filled cache sees only its valid
    prefix, and a scalar-tensor window <= 0 means full context."""
    (q, k, v, _), _ = _inputs(2, 2, 64, 4, 2, 32, "float32")
    q1, pos = q[:, :1], torch.full((2, 1), 39)
    kv_len = torch.full((2,), 40)
    out = attention_reference(q1, k, v, q_positions=pos, kv_length=kv_len)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:], v2[:, 40:] = 1e3, -1e3
    poisoned = attention_reference(q1, k2, v2, q_positions=pos, kv_length=kv_len)
    assert torch.equal(out, poisoned)
    full = torch.arange(64)[None].expand(2, 64)
    assert torch.equal(
        attention_reference(q, k, v, q_positions=full, window=torch.tensor(0)),
        attention_reference(q, k, v, q_positions=full, window=0))
