"""Parameter specs and basic layers (norm, rope, MLP, softcap).

The counterpart of the reference's ``models/layers.py``. Parameters are
declared as ``PSpec`` leaves (shape + logical axes + init) in nested dicts
and lists; :func:`init_params` turns a spec tree into tensors drawn from an
explicit ``torch.Generator`` with the reference's scales. Weights keep the
reference's ``(d_in, d_out)`` layout, so carrying JAX weights across is a
copy (:mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class PSpec:
    """Declarative parameter leaf."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (len == len(shape))
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: float = 0.0  # 0 -> 1/sqrt(fan_in) for normal

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def map_specs(fn, tree) -> Any:
    """Apply ``fn`` to every PSpec leaf of a tree of dicts and lists."""
    if isinstance(tree, PSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, v) for v in tree]
    raise TypeError(f"unexpected spec tree node {type(tree).__name__}")


def init_params(tree, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """Tensors for a PSpec tree: zeros/ones, or normals scaled by
    1/sqrt(fan_in) (``small_normal``: 0.02), as in the reference. Normals are
    drawn in float32 from ``generator`` and cast to ``dtype``."""

    def one(spec: PSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = spec.shape[0] if spec.shape else 1
        scale = spec.scale or (1.0 / max(fan_in, 1)) ** 0.5
        if spec.init == "small_normal":
            scale = 0.02
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)

    return map_specs(one, tree)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with the zero-centred scale: ``x̂ · (1 + weight)``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rms_norm_specs(d: int) -> PSpec:
    # stored as a zero-centred scale (gemma convention); init zeros == identity
    return PSpec((d,), ("embed",), init="zeros")


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split (not interleaved) rope. x: (..., S, H, Dh); positions
    broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a Python base keeps the step free of a host-to-device copy (which would
    # wait for the queued work); the power is still taken in float32
    freq = torch.pow(float(theta), exponent)
    angles = positions[..., None].float() * freq  # (..., S, half)
    angles = angles[..., None, :]  # (..., S, 1, half) broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def gated_mlp_specs(d: int, ff: int) -> Dict[str, PSpec]:
    return {
        "wi_gate": PSpec((d, ff), ("embed", "ff")),
        "wi_up": PSpec((d, ff), ("embed", "ff")),
        "wo": PSpec((ff, d), ("ff", "embed")),
    }


def gated_mlp(params, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU MLP. x: (B, S, D)."""
    g = torch.matmul(x, params["wi_gate"].to(compute_dtype))
    u = torch.matmul(x, params["wi_up"].to(compute_dtype))
    return torch.matmul(F.silu(g) * u, params["wo"].to(compute_dtype))
