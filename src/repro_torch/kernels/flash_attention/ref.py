"""O(S·T) torch oracle for the flash-attention kernel (materialised scores).

The counterpart of the reference's ``kernels/flash_attention/ref.py``: the
same masks, the same finite ``NEG_INF`` and the same ``dh**-0.5`` default
scale."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, S, Hq, Dh)
    k: torch.Tensor,  # (B, T, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_length: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh**-0.5 if scale is None else scale
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= qpos - kpos < window
    if kv_length is not None:
        mask &= kpos < kv_length
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)
