"""The dense layer stack: attention sublayer, gated MLP, per-layer caches.

The counterpart of the reference's ``models/transformer.py`` for dense
attention layers only. Where the reference scans over stacked groups of
layers, the port runs a Python loop over per-layer parameters, so each
layer's sliding window is a plain int (a gemma local layer could take the
flash kernel, where the reference's scan makes its window a traced value).

Mamba, RWKV, MoE and cross-attention layers belong to later slices of the
port and raise ``NotImplementedError``.

Modes: ``prefill`` (full sequence, writes the caches) and ``decode`` (one
token, writes its K/V into the caches at ``cache_len`` and attends over the
valid prefix). Caches are per-layer dicts ``{"k", "v"[, "ks", "vs"]}`` of
``(B, capacity, Hkv, Dh)``, written in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models.attention import attention
from repro_torch.models.layers import (
    PSpec,
    gated_mlp,
    gated_mlp_specs,
    rms_norm,
    rms_norm_specs,
    rotary_embedding,
)

_LATER = {
    "mamba": "the Mamba slice (models/mamba.py with the ssm_scan kernel)",
    "rwkv": "the RWKV-6 slice (models/rwkv6.py with the wkv6 kernel)",
    "moe": "the MoE / hybrid / encoder slice (models/moe.py)",
    "encoder": "the MoE / hybrid / encoder slice (whisper cross-attention)",
    "frontend": "the MoE / hybrid / encoder slice (modality frontend stubs)",
}


def check_supported(arch: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the later slice for any part of
    ``arch`` this slice does not run."""
    for kind, is_moe in arch.layer_kinds():
        if kind not in ("attn", "attn_local"):
            raise NotImplementedError(f"{arch.name}: {kind} layers come with {_LATER[kind]}")
        if is_moe:
            raise NotImplementedError(f"{arch.name}: MoE layers come with {_LATER['moe']}")
    if arch.encoder_layers:
        raise NotImplementedError(f"{arch.name}: encoder-decoder comes with {_LATER['encoder']}")
    if arch.frontend:
        raise NotImplementedError(f"{arch.name}: the {arch.frontend} frontend comes with "
                                  f"{_LATER['frontend']}")


def layer_windows(arch: ArchConfig) -> List[int]:
    """Per-layer sliding window; 0 = full attention."""
    return [
        arch.sliding_window if arch.block_pattern[i % len(arch.block_pattern)] == "attn_local" else 0
        for i in range(arch.num_layers)
    ]


# ---------------------------------------------------------------------------
# Parameter and cache specs
# ---------------------------------------------------------------------------


def attn_specs(arch: ArchConfig) -> Dict[str, PSpec]:
    d = arch.d_model
    dh = arch.resolved_head_dim
    hq, hkv = arch.num_heads, arch.num_kv_heads
    specs = {
        "wq": PSpec((d, hq * dh), ("embed", "heads_out")),
        "wk": PSpec((d, hkv * dh), ("embed", "kv_out")),
        "wv": PSpec((d, hkv * dh), ("embed", "kv_out")),
        "wo": PSpec((hq * dh, d), ("heads_out", "embed")),
    }
    if arch.qkv_bias:
        specs["bq"] = PSpec((hq * dh,), ("heads_out",), init="zeros")
        specs["bk"] = PSpec((hkv * dh,), ("kv_out",), init="zeros")
        specs["bv"] = PSpec((hkv * dh,), ("kv_out",), init="zeros")
    return specs


def layer_specs(arch: ArchConfig) -> Dict[str, Any]:
    d = arch.d_model
    return {
        "ln1": rms_norm_specs(d),
        "ln2": rms_norm_specs(d),
        "attn": attn_specs(arch),
        "mlp": gated_mlp_specs(d, arch.d_ff),
    }


def stack_specs(arch: ArchConfig) -> List[Dict[str, Any]]:
    """One spec dict per layer (the reference stacks them along a group axis)."""
    check_supported(arch)
    return [layer_specs(arch) for _ in range(arch.num_layers)]


def cache_dtypes(run: RunConfig) -> Dict[str, torch.dtype]:
    """KV in kv_cache_dtype (int8 or bf16), the int8 scales in f32."""
    kv = torch.int8 if run.kv_cache_dtype == "int8" else torch.bfloat16
    out = {"k": kv, "v": kv}
    if run.kv_cache_dtype == "int8":
        out.update(ks=torch.float32, vs=torch.float32)
    return out


def cache_init(arch: ArchConfig, run: RunConfig, batch: int, capacity: int,
               device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """Per-layer caches at ``capacity``: K/V zeros, int8 scales ones."""
    check_supported(arch)
    dh, hkv = arch.resolved_head_dim, arch.num_kv_heads
    dtypes = cache_dtypes(run)
    caches = []
    for _ in range(arch.num_layers):
        layer = {}
        for name, dt in dtypes.items():
            shape = (batch, capacity, hkv, dh) if name in ("k", "v") else (batch, capacity, hkv)
            fill = torch.ones if name in ("ks", "vs") else torch.zeros
            layer[name] = fill(shape, dtype=dt, device=device)
        caches.append(layer)
    return caches


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


@dataclass
class Ctx:
    """Per-call context threaded through the stack."""

    arch: ArchConfig
    run: RunConfig
    mode: str  # prefill | decode
    positions: torch.Tensor  # (B, S) global positions of the current tokens
    cache_len: Optional[int] = None  # decode: valid prefix length

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.run.compute_dtype)


def _quantize_kv(x: torch.Tensor):
    """(B,S,H,Dh) -> int8 values + (B,S,H) f32 scales."""
    scale = x.float().abs().amax(dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(x.float() / scale[..., None]).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _attn_sublayer(p, h: torch.Tensor, ctx: Ctx, *, window: int,
                   cache: Optional[Dict[str, torch.Tensor]]):
    """h: normed input (B,S,D). Writes this call's K/V into ``cache`` (in
    place) when one is given. Returns (out (B,S,D), cache)."""
    arch, run = ctx.arch, ctx.run
    b, s, _ = h.shape
    dh = arch.resolved_head_dim
    hq, hkv = arch.num_heads, arch.num_kv_heads
    cd = ctx.compute_dtype

    def proj(name, n_h):
        y = torch.matmul(h, p[name].to(cd))
        bias = p.get("b" + name[-1])
        if bias is not None:
            y = y + bias.to(cd)
        return y.reshape(b, s, n_h, dh)

    q = rotary_embedding(proj("wq", hq), ctx.positions, arch.rope_theta)
    k = rotary_embedding(proj("wk", hkv), ctx.positions, arch.rope_theta)
    v = proj("wv", hkv)
    int8 = run.kv_cache_dtype == "int8"

    kv_len = None
    if ctx.mode == "decode":
        # insert the new token's K/V at cache_len, attend over the prefix
        pos = ctx.cache_len
        if int8:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            cache["k"][:, pos:pos + 1] = kq
            cache["v"][:, pos:pos + 1] = vq
            cache["ks"][:, pos:pos + 1] = ks
            cache["vs"][:, pos:pos + 1] = vs
            k_use = _dequantize_kv(cache["k"], cache["ks"], cd)
            v_use = _dequantize_kv(cache["v"], cache["vs"], cd)
        else:
            cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
            cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
            k_use, v_use = cache["k"].to(cd), cache["v"].to(cd)
        kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    else:
        if cache is not None:
            if int8:
                kq, ks = _quantize_kv(k)
                vq, vs = _quantize_kv(v)
                cache["k"][:, :s], cache["v"][:, :s] = kq, vq
                cache["ks"][:, :s], cache["vs"][:, :s] = ks, vs
            else:
                cache["k"][:, :s] = k.to(cache["k"].dtype)
                cache["v"][:, :s] = v.to(cache["v"].dtype)
        k_use, v_use = k, v  # prefill attends over its own, unrounded K/V

    out = attention(
        q, k_use, v_use, q_positions=ctx.positions, kv_length=kv_len,
        causal=True, window=window, softcap_val=arch.attn_logit_softcap,
        block_kv=run.attn_block_kv,
        impl=run.attention_impl if ctx.mode != "decode" else "torch",
    )
    out = torch.matmul(out.reshape(b, s, hq * dh), p["wo"].to(cd))
    return out, cache


def apply_layer(p, x: torch.Tensor, ctx: Ctx, *, window: int,
                cache: Optional[Dict[str, torch.Tensor]]):
    """Pre-norm residual dense layer. Returns (x, cache)."""
    eps = ctx.arch.norm_eps
    out, cache = _attn_sublayer(p["attn"], rms_norm(x, p["ln1"], eps), ctx,
                                window=window, cache=cache)
    x = x + out
    x = x + gated_mlp(p["mlp"], rms_norm(x, p["ln2"], eps), ctx.compute_dtype)
    return x, cache


def apply_stack(layers, x: torch.Tensor, ctx: Ctx, *, caches=None):
    """Run the layers in order (the reference's scan). ``caches``: per-layer
    cache dicts written in place, or None. Returns (x, caches)."""
    windows = layer_windows(ctx.arch)
    for i, p in enumerate(layers):
        cache = caches[i] if caches is not None else None
        x, _ = apply_layer(p, x, ctx, window=windows[i], cache=cache)
    return x, caches
