"""GQA attention: a blockwise online-softmax torch path + the flash kernel.

The counterpart of the reference's ``models/attention.py``. ``impl="torch"``
(the reference's ``"xla"``) is a single-shot masked softmax for decode and
short contexts, else an online softmax over KV blocks of ``block_kv``, with
K/V repeated to the query-head count inside each block. ``impl="kernel"``
(the reference's ``"pallas"``) calls the hand-written CUDA flash kernel
through :func:`repro_torch.kernels.flash_attention.ops.flash_attention`.

``window`` may be an int or a scalar tensor (then ≤ 0 means full context).
The port runs its layers in a Python loop, so the model passes plain ints.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30

Window = Union[int, torch.Tensor]


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return s
    return cap * torch.tanh(s / cap)


def _mask(qpos, kpos, *, causal: bool, window: Window, kv_length):
    """qpos: (B,1,S,1); kpos: (1,1,1,T) -> bool (B,1,S,T)."""
    mask = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if isinstance(window, torch.Tensor):
        mask &= (qpos - kpos < window) | (window <= 0)
    elif window > 0:
        mask &= qpos - kpos < window
    if kv_length is not None:
        mask &= kpos < kv_length[:, None, None, None]
    return mask


def _neg_inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, NEG_INF, dtype=torch.float32)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_length: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Window = 0,
    softcap_val: float = 0.0,
    block_kv: int = 512,
    impl: str = "torch",
) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, S, Hq, Dh); k, v: (B, T, Hkv, Dh). ``q_positions``: (B, S) global
    positions of the queries (decode with a cache offset). ``kv_length``:
    optional (B,) valid KV prefix length (decode caches). Returns
    (B, S, Hq, Dh)."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qs = q * dh**-0.5  # pre-scaled in the compute dtype

    if impl == "kernel":
        from repro_torch.kernels.flash_attention import ops as fa_ops

        return fa_ops.flash_attention(
            qs, k, v, q_positions=q_positions, kv_length=kv_length,
            causal=causal, window=window, softcap_val=softcap_val,
            block_kv=block_kv,
        )
    if impl != "torch":
        raise ValueError(f"attention impl {impl!r}: use 'torch' or 'kernel'")

    def expand(x):  # (B, T', Hkv, Dh) -> (B, T', Hq, Dh)
        return x if g == 1 else x.repeat_interleave(g, dim=2)

    qpos = q_positions[:, None, :, None]  # (B,1,S,1)

    if s == 1 or t <= block_kv:
        # decode / short context: single-shot masked attention (linear in T)
        scores = torch.einsum("bshd,bthd->bhst", qs, expand(k))
        scores = _softcap(scores, softcap_val)
        kpos = torch.arange(t, device=q.device)[None, None, None, :]
        m = _mask(qpos, kpos, causal=causal, window=window, kv_length=kv_length)
        scores = torch.where(m, scores.float(), _neg_inf_like(scores))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, expand(v))

    # blockwise online softmax over KV blocks (zero-padded, pad masked)
    n_blocks = -(-t // block_kv)
    pad = n_blocks * block_kv - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    m_run = torch.full((b, hq, s), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, hq, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, dh), dtype=torch.float32, device=q.device)
    for idx in range(n_blocks):
        lo = idx * block_kv
        kblk, vblk = k[:, lo:lo + block_kv], v[:, lo:lo + block_kv]
        scores = torch.einsum("bshd,bthd->bhst", qs, expand(kblk))
        scores = _softcap(scores, softcap_val)
        kpos = (lo + torch.arange(block_kv, device=q.device))[None, None, None, :]
        msk = (kpos < t) & _mask(qpos, kpos, causal=causal, window=window,
                                 kv_length=kv_length)
        scores = torch.where(msk, scores.float(), _neg_inf_like(scores))
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * corr + p.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bhsd", p.to(q.dtype), expand(vblk))
        acc = acc * corr[..., None] + pv.float()
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]  # (B,Hq,S,Dh)
    return out.transpose(1, 2).to(q.dtype)


def attention_reference(q, k, v, *, q_positions, kv_length=None, causal=True,
                        window=0, softcap_val=0.0):
    """Naive O(S·T) oracle with :func:`attention`'s signature (positions,
    per-batch ``kv_length``, scalar-tensor windows); the tests hold both
    impls of :func:`attention` against it."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q * dh**-0.5, k)
    scores = _softcap(scores, softcap_val).float()
    kpos = torch.arange(t, device=q.device)[None, None, None, :]
    qpos = q_positions[:, None, :, None]
    m = _mask(qpos, kpos, causal=causal, window=window, kv_length=kv_length)
    scores = torch.where(m, scores, _neg_inf_like(scores))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)
