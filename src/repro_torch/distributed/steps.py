"""Single-device step builders for serving: prefill and decode callables.

The counterpart of ``make_prefill_step`` / ``make_decode_step`` in the
reference's ``distributed/steps.py``, without a mesh (sharding is a later
slice). What carries over: ``_effective_run`` (``matmul_precision="f32"``
sets the compute dtype to float32) and serving weights without f32 masters
(``param_dtype = weight_dtype``). The reference donates the decode caches;
here the caches are written in place.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models.model import Model


def _effective_run(run: RunConfig) -> RunConfig:
    """Resolve derived knobs (matmul precision → compute dtype)."""
    if run.matmul_precision == "f32" and run.compute_dtype != "float32":
        run = run.replace(compute_dtype="float32")
    return run


def _serve_model(arch: ArchConfig, run: RunConfig) -> Model:
    run = _effective_run(run)
    if run.weight_dtype not in ("bfloat16", "float32"):
        raise NotImplementedError(
            f"weight_dtype={run.weight_dtype!r}: int8 serving weights are a "
            "later slice of the port")
    return Model(arch, run.replace(param_dtype=run.weight_dtype))  # serve: no f32 masters


@dataclass
class PrefillStep:
    """``step(params, tokens, caches=None) -> (last-token logits, caches)``."""

    model: Model

    def __call__(self, params, tokens, caches=None):
        return self.model.prefill(params, tokens, caches)


@dataclass
class DecodeStep:
    """``step(params, caches, tokens, cache_len) -> (logits, caches)``; the
    caches are updated in place."""

    model: Model

    def __call__(self, params, caches, tokens, cache_len: int):
        return self.model.decode_step(params, caches, tokens, cache_len)


def make_prefill_step(arch: ArchConfig, run: RunConfig) -> PrefillStep:
    return PrefillStep(_serve_model(arch, run))


def make_decode_step(arch: ArchConfig, run: RunConfig) -> DecodeStep:
    return DecodeStep(_serve_model(arch, run))
