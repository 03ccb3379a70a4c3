"""The port's dense model held against the JAX reference on the CPU.

Weights are the reference's ``Model.init_params(PRNGKey(0))`` carried across
by ``params_from_jax``; tokens come from ``numpy.random.default_rng``.
Prefill last-token logits and K/V caches, then four decode steps, are
compared: reference ``"xla"`` against port ``"torch"``, and the reference's
Pallas kernel in interpret mode against port ``"kernel"`` (on CPU tensors
the kernel's plain version). Tolerances are the reference's numerics gate,
``max|a-b| / max|ref|`` below 1e-4 at f32 compute and 3e-2 at bf16. The
caches are stored in bf16 or int8 whatever the compute dtype, so they are
held to the bf16 tolerance: one rounding step of a stored value that lands
on the other side of a tie is 2^-8 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import get_arch as jax_get_arch
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models.model import Model as JaxModel
from repro_torch.configs.archs import get_arch
from repro_torch.configs.base import RunConfig
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models.convert import params_from_jax, tensor_from_numpy, unstack_layers
from repro_torch.models.model import Model

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CACHE_TOL = 3e-2
B, S, STEPS = 2, 24, 4
IMPLS = {"torch": "xla", "kernel": "pallas"}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(x, dtype=np.float32)


def _rel(port, ref) -> float:
    a, r = _f32(port), _f32(ref)
    return float(np.abs(a - r).max() / np.abs(r).max())


def _models(arch_name, impl, compute_dtype, kv):
    run = dict(compute_dtype=compute_dtype, kv_cache_dtype=kv)
    jm = JaxModel(jax_get_arch(arch_name, smoke=True),
                  JaxRunConfig(attention_impl=IMPLS[impl], **run))
    tm = Model(get_arch(arch_name, smoke=True), RunConfig(attention_impl=impl, **run))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.arch)
    tokens = np.random.default_rng(0).integers(0, tm.arch.vocab_size, (B, S + STEPS))
    return jm, jp, tm, tp, tokens


def _dequant(layer, name):
    """A cache leaf as float: int8 values times their scales, else itself."""
    x = _f32(layer[name])
    scale = layer.get(name + "s")
    return x * _f32(scale)[..., None] if scale is not None else x


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("arch_name", ["llama3.2-1b", "qwen2-72b"])
def test_prefill_matches_reference(arch_name, impl, compute_dtype, kv):
    jm, jp, tm, tp, tokens = _models(arch_name, impl, compute_dtype, kv)
    prompt = tokens[:, :S]
    j_logits, j_caches = jax.jit(
        lambda p, t: jm.prefill(p, {"tokens": t}, interpret=True)
    )(jp, jnp.asarray(prompt, jnp.int32))
    launches = fa_kernel.LAUNCHES
    t_logits, t_caches = tm.prefill(tp, torch.from_numpy(prompt))
    assert fa_kernel.LAUNCHES == launches  # CPU tensors never launch
    assert t_logits.shape == (B, tm.arch.padded_vocab)
    assert t_logits.dtype == getattr(torch, compute_dtype)
    assert _rel(t_logits, j_logits) < TOL[compute_dtype]

    j_layers = unstack_layers(jax.tree.map(np.asarray, j_caches), tm.arch.num_layers)
    assert len(t_caches) == len(j_layers)
    for t_layer, j_layer in zip(t_caches, j_layers):
        assert set(t_layer) == set(j_layer)
        for name in ("k", "v"):
            assert t_layer[name].dtype == tensor_from_numpy(j_layer[name]).dtype
            assert t_layer[name].shape == j_layer[name].shape
            assert _rel(_dequant(t_layer, name), _dequant(j_layer, name)) < CACHE_TOL


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch_name", ["llama3.2-1b", "qwen2-72b"])
def test_decode_steps_match_reference(arch_name, compute_dtype, kv):
    jm, jp, tm, tp, tokens = _models(arch_name, "torch", compute_dtype, kv)
    prompt = tokens[:, :S]
    _, j_caches = jm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)})
    # the reference's serve loop pads the prefill caches to decode capacity
    j_caches = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.pad(x, [(0, 0), (0, 0), (0, STEPS)] + [(0, 0)] * (x.ndim - 3)),
        j_caches)
    t_caches = tm.cache_init(B, S + STEPS, torch.device("cpu"))
    tm.prefill(tp, torch.from_numpy(prompt), t_caches)
    j_step = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = tokens[:, S + i:S + i + 1]
        j_logits, j_caches = j_step(jp, j_caches, {
            "tokens": jnp.asarray(tok, jnp.int32),
            "cache_len": jnp.asarray(S + i, jnp.int32)})
        t_logits, t_caches = tm.decode_step(tp, t_caches, torch.from_numpy(tok), S + i)
        assert _rel(t_logits, j_logits) < TOL[compute_dtype], i


@pytest.mark.parametrize("block_kv", [512, 10])  # single-shot; blockwise with a padded tail
@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("arch_name", ["gemma2-9b", "gemma3-1b"])
def test_windowed_softcapped_archs_match_reference(arch_name, impl, block_kv):
    """Local/global window stacks with logit softcaps, held against the
    reference's torch-free path ("xla"): its scan makes the per-layer window
    a traced value, which its Pallas kernel rejects, while the port's Python
    layer loop hands the kernel a plain int."""
    run = dict(compute_dtype="float32", attn_block_kv=block_kv)
    jm = JaxModel(jax_get_arch(arch_name, smoke=True), JaxRunConfig(attention_impl="xla", **run))
    tm = Model(get_arch(arch_name, smoke=True), RunConfig(attention_impl=impl, **run))
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.arch)
    prompt = np.random.default_rng(1).integers(0, tm.arch.vocab_size, (B, S))
    assert S > tm.arch.sliding_window  # the window masks something
    j_logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)})
    t_logits, _ = tm.prefill(tp, torch.from_numpy(prompt))
    assert _rel(t_logits, j_logits) < TOL["float32"]


def test_unported_families_raise():
    for name, word in [("rwkv6-7b", "RWKV"), ("jamba-1.5-large-398b", "Mamba"),
                       ("phi3.5-moe-42b-a6.6b", "MoE"), ("whisper-tiny", "encoder"),
                       ("internvl2-26b", "frontend")]:
        with pytest.raises(NotImplementedError, match=word):
            Model(get_arch(name, smoke=True), RunConfig())


def test_init_params_is_seeded_and_shaped():
    model = Model(get_arch("llama3.2-1b", smoke=True), RunConfig(param_dtype="bfloat16"))
    make = lambda: model.init_params(torch.Generator().manual_seed(3), torch.device("cpu"))
    a, b = make(), make()
    arch = model.arch
    assert len(a["layers"]) == arch.num_layers
    assert a["embed"].shape == (arch.padded_vocab, arch.d_model)
    assert a["embed"].dtype == torch.bfloat16
    assert a["layers"][0]["attn"]["wq"].shape == (arch.d_model, arch.num_heads * arch.resolved_head_dim)
    assert torch.equal(a["layers"][1]["mlp"]["wo"], b["layers"][1]["mlp"]["wo"])
    assert not a["final_norm"].any()  # zero-centred norm scale: identity at init
    # the reference's fan-in scale: std ~ 1/sqrt(d_in)
    std = a["layers"][0]["mlp"]["wi_up"].float().std().item()
    assert abs(std * arch.d_model**0.5 - 1.0) < 0.1
