"""Public entry point of the selective-scan kernel
(``repro/kernels/ssm_scan/ops.py``).

``chunk`` is clamped to the sequence length and ``d_block`` halved until it
divides the channel dim (both idempotent and the reference's own snaps, so
the tuner's aliases are the reference's); when the caller passes nothing,
the port's own tuned table for this (dtype, shape class) fills them
(:mod:`repro_torch.kernels`), else the defaults. :func:`smem_footprint`
(the kernel's shared memory, in place of the reference's ``vmem_footprint``)
is checked against :data:`SMEM_LIMIT`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import dtype_token, ssm_shape_class, tuned_config
from repro_torch.kernels.ssm_scan.kernel import SMEM_LIMIT, smem_footprint, ssm_scan

__all__ = ["DEFAULT_CHUNK", "DEFAULT_D_BLOCK", "SMEM_LIMIT", "selective_scan",
           "smem_footprint", "snap_chunk", "snap_d_block"]

DEFAULT_CHUNK = 128
DEFAULT_D_BLOCK = 256


def snap_chunk(chunk: int, seq_len: int) -> int:
    """Clamp a chunk length to the sequence (idempotent)."""
    return max(1, min(int(chunk), int(seq_len)))


def snap_d_block(d_block: int, di: int) -> int:
    """Halve until it divides the channel dim (idempotent)."""
    d_block = max(1, int(d_block))
    while di % d_block:
        d_block //= 2
    return max(d_block, 1)


def selective_scan(dt, u, b_t, c_t, a, *, chunk: Optional[int] = None,
                   d_block: Optional[int] = None):
    if chunk is None or d_block is None:
        tuned = tuned_config(
            "ssm_scan", dtype_token(dt.dtype),
            ssm_shape_class(tuple(dt.shape), a.shape[-1]),
        ) or {}
        if chunk is None:
            chunk = int(tuned.get("chunk", DEFAULT_CHUNK))
        if d_block is None:
            d_block = int(tuned.get("d_block", DEFAULT_D_BLOCK))
    chunk = snap_chunk(chunk, dt.shape[1])
    d_block = snap_d_block(d_block, dt.shape[-1])
    return ssm_scan(dt, u, b_t, c_t, a, chunk=chunk, d_block=d_block)
