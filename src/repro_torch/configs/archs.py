"""The 10 assigned architectures (full + smoke variants) and the registry.

A copy of the reference's ``configs/archs.py``: the entries are data. This
slice's model runs the dense family only; ``Model`` raises
``NotImplementedError`` for the others.

Full configs follow the assignment sheet exactly (layers / d_model / heads /
kv heads / d_ff / vocab / family-specific structure). Smoke variants keep the
same *family structure* (same block/MoE patterns, same period) at toy size so
one train/serve step runs on a single CPU device.

``skip_shapes`` records the cells that are architecturally inapplicable
(documented in DESIGN.md §6): ``long_500k`` runs only for the SSM/hybrid
archs (rwkv6, jamba); whisper's decoder shapes are structurally exercised but
``long_500k`` is skipped (enc-dec, quadratic decoder).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig

_SKIP_LONG = ("long_500k",)

FULL: Dict[str, ArchConfig] = {}
SMOKE: Dict[str, ArchConfig] = {}


def _register(full: ArchConfig, smoke: ArchConfig):
    FULL[full.name] = full
    assert smoke.name == full.name
    SMOKE[full.name] = smoke


# --------------------------------------------------------------------- vlm
# InternVL2-26B: InternViT frontend (stub patch embeddings) + InternLM2-20B
# backbone. [arXiv:2404.16821]
_register(
    ArchConfig(
        name="internvl2-26b", family="vlm", num_layers=48, d_model=6144,
        num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92553,
        rope_theta=1e6, frontend="vision", frontend_seq=1025,
        skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="internvl2-26b", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        frontend="vision", frontend_seq=9, skip_shapes=_SKIP_LONG,
    ),
)

# --------------------------------------------------------------------- ssm
# RWKV-6 "Finch" 7B: attention-free, data-dependent decay. [arXiv:2404.05892]
_register(
    ArchConfig(
        name="rwkv6-7b", family="ssm", num_layers=32, d_model=4096,
        num_heads=64, num_kv_heads=64, d_ff=14336, vocab_size=65536,
        block_pattern=("rwkv",), rwkv_head_dim=64,
    ),
    ArchConfig(
        name="rwkv6-7b", family="ssm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
        block_pattern=("rwkv",), rwkv_head_dim=16,
    ),
)

# ------------------------------------------------------------------- dense
# Llama-3.2-1B. [hf:meta-llama/Llama-3.2-1B]
_register(
    ArchConfig(
        name="llama3.2-1b", family="dense", num_layers=16, d_model=2048,
        num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=128256,
        rope_theta=500000.0, tie_embeddings=True, skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="llama3.2-1b", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        tie_embeddings=True, skip_shapes=_SKIP_LONG,
    ),
)

# Gemma-2 9B: 1:1 local(4096):global alternation, logit softcaps, head_dim
# 256 ≠ d/H. [arXiv:2408.00118]
_register(
    ArchConfig(
        name="gemma2-9b", family="dense", num_layers=42, d_model=3584,
        num_heads=16, num_kv_heads=8, d_ff=14336, vocab_size=256000,
        head_dim=256, block_pattern=("attn_local", "attn"), sliding_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0, tie_embeddings=True,
        skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="gemma2-9b", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=32,
        block_pattern=("attn_local", "attn"), sliding_window=8,
        attn_logit_softcap=50.0, final_logit_softcap=30.0, tie_embeddings=True,
        skip_shapes=_SKIP_LONG,
    ),
)

# Qwen2-72B: GQA + QKV bias. [arXiv:2407.10671]
_register(
    ArchConfig(
        name="qwen2-72b", family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, d_ff=29568, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6, skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="qwen2-72b", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        qkv_bias=True, skip_shapes=_SKIP_LONG,
    ),
)

# Gemma-3 1B: 5:1 local(512):global, MQA (kv=1), 262k vocab.
# [hf:google/gemma-3-1b-pt]
_register(
    ArchConfig(
        name="gemma3-1b", family="dense", num_layers=26, d_model=1152,
        num_heads=4, num_kv_heads=1, d_ff=6912, vocab_size=262144,
        head_dim=256,
        block_pattern=("attn_local",) * 5 + ("attn",), sliding_window=512,
        rope_theta=1e6, tie_embeddings=True, skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="gemma3-1b", family="dense", num_layers=6, d_model=64,
        num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=512, head_dim=32,
        block_pattern=("attn_local",) * 5 + ("attn",), sliding_window=8,
        tie_embeddings=True, skip_shapes=_SKIP_LONG,
    ),
)

# --------------------------------------------------------------------- moe
# Llama-4 Maverick 400B-A17B: 128 experts top-1, dense/MoE interleave.
# [hf:meta-llama/Llama-4-Scout-17B-16E (family)]
_register(
    ArchConfig(
        name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
        d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192,
        vocab_size=202048, rope_theta=500000.0,
        num_experts=128, experts_per_token=1, moe_pattern=(False, True),
        skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="llama4-maverick-400b-a17b", family="moe", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=1, moe_pattern=(False, True),
        skip_shapes=_SKIP_LONG,
    ),
)

# Phi-3.5-MoE 42B-A6.6B: 16 experts top-2, every layer MoE.
# [hf:microsoft/Phi-3.5-MoE-instruct]
_register(
    ArchConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, d_ff=6400,
        vocab_size=32064,
        num_experts=16, experts_per_token=2, moe_pattern=(True,),
        skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=2, moe_pattern=(True,),
        skip_shapes=_SKIP_LONG,
    ),
)

# ------------------------------------------------------------------ hybrid
# Jamba-1.5-Large: 1:7 attn:mamba interleave, MoE every other layer (16e
# top-2). [arXiv:2403.19887]
_register(
    ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid", num_layers=72,
        d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
        vocab_size=65536,
        block_pattern=("attn",) + ("mamba",) * 7, moe_pattern=(False, True),
        num_experts=16, experts_per_token=2,
        ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
    ),
    ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid", num_layers=8,
        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        block_pattern=("attn",) + ("mamba",) * 7, moe_pattern=(False, True),
        num_experts=4, experts_per_token=2,
        ssm_state_dim=4, ssm_conv_width=4, ssm_expand=2,
    ),
)

# ------------------------------------------------------------------- audio
# Whisper-tiny: enc-dec; conv frontend is a stub that provides (B, 1500, 384)
# frame embeddings. [arXiv:2212.04356]
_register(
    ArchConfig(
        name="whisper-tiny", family="audio", num_layers=4, d_model=384,
        num_heads=6, num_kv_heads=6, d_ff=1536, vocab_size=51865,
        encoder_layers=4, frontend="audio", frontend_seq=1500,
        skip_shapes=_SKIP_LONG,
    ),
    ArchConfig(
        name="whisper-tiny", family="audio", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
        encoder_layers=2, frontend="audio", frontend_seq=12,
        skip_shapes=_SKIP_LONG,
    ),
)

ARCH_NAMES = tuple(FULL.keys())


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKE if smoke else FULL
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]

