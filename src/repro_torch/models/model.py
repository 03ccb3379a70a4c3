"""Model facade: ``ArchConfig × RunConfig → init / prefill / decode``.

The counterpart of the reference's ``models/model.py`` for the serving path
of dense models:

  - ``param_specs()``        — PSpec tree (embedding, per-layer list, norm)
  - ``init_params(...)``     — tensors from an explicit ``torch.Generator``
  - ``cache_init(...)``      — per-layer KV caches at a capacity
  - ``prefill(params, tokens)``  — full-sequence forward, fills caches
  - ``decode_step(params, caches, tokens, cache_len)`` — one token

Training (``loss``) and the dry-run stand-ins are later slices. A model of a
family this slice cannot run raises ``NotImplementedError`` at construction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import PSpec, init_params, rms_norm, rms_norm_specs, softcap


@dataclass
class Model:
    arch: ArchConfig
    run: RunConfig

    def __post_init__(self):
        tfm.check_supported(self.arch)

    # ------------------------------------------------------------------ params

    def param_specs(self) -> Dict[str, Any]:
        arch = self.arch
        d = arch.d_model
        specs: Dict[str, Any] = {
            "embed": PSpec((arch.padded_vocab, d), ("vocab", "embed"), init="small_normal"),
            "layers": tfm.stack_specs(arch),
            "final_norm": rms_norm_specs(d),
        }
        if not arch.tie_embeddings:
            specs["unembed"] = PSpec((arch.padded_vocab, d), ("vocab", "embed"),
                                     init="small_normal")
        return specs

    def init_params(self, generator: torch.Generator, device: torch.device,
                    dtype: Optional[torch.dtype] = None):
        dtype = dtype or getattr(torch, self.run.param_dtype)
        return init_params(self.param_specs(), generator, dtype, device)

    # ------------------------------------------------------------------ caches

    def cache_init(self, batch: int, capacity: int,
                   device: torch.device) -> List[Dict[str, torch.Tensor]]:
        return tfm.cache_init(self.arch, self.run, batch, capacity, device)

    # ----------------------------------------------------------------- forward

    def _ctx(self, mode: str, positions: torch.Tensor, cache_len=None) -> tfm.Ctx:
        return tfm.Ctx(arch=self.arch, run=self.run, mode=mode,
                       positions=positions, cache_len=cache_len)

    def _embed_inputs(self, params, tokens: torch.Tensor, ctx: tfm.Ctx) -> torch.Tensor:
        cd = ctx.compute_dtype
        x = params["embed"].to(cd)[tokens]
        if self.arch.tie_embeddings:
            # the sqrt(d) scale is computed in the compute dtype, as in the
            # reference, on the host: a device scalar would cost a copy that
            # waits for the queued work
            x = x * float(torch.tensor(self.arch.d_model, dtype=cd) ** 0.5)
        return x

    def _logits(self, params, x: torch.Tensor, ctx: tfm.Ctx) -> torch.Tensor:
        """Logits in the compute dtype, with the final softcap."""
        table = params["embed"] if self.arch.tie_embeddings else params["unembed"]
        logits = torch.matmul(x, table.to(ctx.compute_dtype).t())
        return softcap(logits, self.arch.final_logit_softcap)

    def _cast_params(self, params, ctx: tfm.Ctx):
        """Narrow wider float weights to the compute dtype once, before the
        layers (int8 weights keep their per-layer dequant)."""
        cd = ctx.compute_dtype

        def cast(w):
            if isinstance(w, dict):
                return {k: cast(v) for k, v in w.items()}
            if isinstance(w, list):
                return [cast(v) for v in w]
            if w.is_floating_point() and w.element_size() > torch.empty((), dtype=cd).element_size():
                return w.to(cd)
            return w

        return cast(params)

    def _backbone(self, params, x, ctx: tfm.Ctx, caches):
        x, caches = tfm.apply_stack(params["layers"], x, ctx, caches=caches)
        return rms_norm(x, params["final_norm"], self.arch.norm_eps), caches

    # ------------------------------------------------------------------- serve

    def prefill(self, params, tokens: torch.Tensor, caches=None):
        """Full-sequence forward. Writes K/V into ``caches`` (positions
        0..S-1, in place); with none given, allocates caches of capacity S.
        Returns (last-token logits (B, V), caches)."""
        b, s = tokens.shape
        if caches is None:
            caches = self.cache_init(b, s, tokens.device)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        ctx = self._ctx("prefill", positions)
        params = self._cast_params(params, ctx)
        x = self._embed_inputs(params, tokens, ctx)
        x, caches = self._backbone(params, x, ctx, caches)
        logits = self._logits(params, x[:, -1:, :], ctx)
        return logits[:, 0], caches

    def decode_step(self, params, caches, tokens: torch.Tensor, cache_len: int):
        """One decode step. tokens: (B, 1); ``cache_len`` the valid prefix,
        where this token's K/V is written (in place). Returns (logits (B, V),
        caches)."""
        b = tokens.shape[0]
        positions = torch.full((b, 1), int(cache_len), dtype=torch.int32, device=tokens.device)
        ctx = self._ctx("decode", positions, cache_len=int(cache_len))
        params = self._cast_params(params, ctx)
        x = self._embed_inputs(params, tokens, ctx)
        x, caches = self._backbone(params, x, ctx, caches)
        logits = self._logits(params, x, ctx)
        return logits[:, 0], caches
