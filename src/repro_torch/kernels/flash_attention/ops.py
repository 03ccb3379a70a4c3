"""Public entry point of the flash-attention kernel, with the reference's
routing rules (``repro/kernels/flash_attention/ops.py``):

  - a window that is not a Python number → ValueError (per-layer windows
    held in tensors go to the model's torch path),
  - decode (S == 1) → ValueError (a decode step is gather-bound, not a flash
    workload; the model routes it to the torch path),
  - ``kv_length`` given as a tensor → ValueError (the kernel takes a static
    valid prefix),
  - ``q_positions`` is accepted and ignored: queries start at position 0.

Block sizes: a caller's ``block_q``/``block_kv`` is snapped onto a tile the
kernel is compiled for (:func:`snap_block`). A caller that passes none gets
the tuned entry for this (dtype, shape class) from the port's own table
(:mod:`repro_torch.kernels`), else the default.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtype_token, flash_shape_class, tuned_config
from repro_torch.kernels.flash_attention.kernel import (
    DEFAULT_BLOCK,
    TILES,
    flash_attention_fwd,
)

# per-block opt-in shared memory of an H100 (227 KB)
SMEM_LIMIT = 232448


def smem_footprint(block_q: int, block_kv: int, dh: int, dtype_bytes: int = 4) -> int:
    """Shared-memory bytes of one thread block of ``csrc/flash_fwd.cu``: the
    q tile, K^T, V and the probability tile, each padded as the kernel pads
    them. Tiles are staged as f32 whatever the input dtype, so an input
    narrower than 4 bytes costs as much as f32. Monotone in both blocks, so
    a pair of tiles that each fit alone at the larger size fits together."""
    bq, bkv, dh = int(block_q), int(block_kv), int(dh)
    stage = max(int(dtype_bytes), 4)
    floats = bq * (dh + 1) + dh * (bkv + 1) + bkv * dh + bq * (bkv + 1)
    return floats * stage


def snap_block(block: int, seq_len: int, dh: int, dtype=torch.float32) -> int:
    """Map any knob value (the tuner's grid offers 128..2048) onto a tile the
    kernel supports: the largest of ``TILES`` that is at most the block, at
    most the sequence padded to the smallest tile, and whose square tile pair
    fits :data:`SMEM_LIMIT` at this head dim. Idempotent: a snapped value
    snaps to itself."""
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    fits = [t for t in TILES if smem_footprint(t, t, dh, dtype_bytes) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no flash tile fits shared memory at dh={dh}")
    lo = fits[0]
    padded = -(-max(int(seq_len), 1) // lo) * lo
    cap = min(max(int(block), lo), padded)
    return max(t for t in fits if t <= cap)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions=None,  # accepted for parity with the reference; queries start at 0
    kv_length=None,
    causal: bool = True,
    window=0,
    softcap_val: float = 0.0,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    scale: Optional[float] = 1.0,  # the model pre-scales q
) -> torch.Tensor:
    if isinstance(window, bool) or not isinstance(window, (int, float)):
        raise ValueError(
            "the flash kernel needs a static window; per-layer windows held "
            "in tensors must use attention_impl='torch'"
        )
    if q.shape[1] == 1:
        raise ValueError("decode steps use the torch attention path")
    kv_len = None
    if kv_length is not None:
        if isinstance(kv_length, torch.Tensor):
            raise ValueError("the flash kernel needs a static int kv_length")
        kv_len = int(kv_length)
    if block_q is None or block_kv is None:
        tuned = tuned_config(
            "flash_attention", dtype_token(q.dtype),
            flash_shape_class(tuple(q.shape), tuple(k.shape)),
        ) or {}
        if block_q is None:
            block_q = int(tuned.get("block_q", DEFAULT_BLOCK))
        if block_kv is None:
            block_kv = int(tuned.get("block_kv", DEFAULT_BLOCK))
    dh = q.shape[-1]
    block_q = snap_block(block_q, q.shape[1], dh, q.dtype)
    block_kv = snap_block(block_kv, k.shape[1], dh, q.dtype)
    return flash_attention_fwd(
        q, k, v,
        causal=causal, window=int(window), softcap=float(softcap_val),
        kv_length=kv_len, block_q=block_q, block_kv=block_kv, scale=scale,
    )
