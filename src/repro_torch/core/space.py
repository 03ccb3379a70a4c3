"""Tunable configuration spaces — the paper's §III "parameters" tables.

The paper curates 12 Hadoop and 11 Spark parameters (out of ~200/~180), each
with a default and a bounded range, and two value types: *continuous*
(numeric, sampled with a predefined step) and *boolean/categorical*. We mirror
that exactly for the two "platforms" of a distributed JAX framework:

  - ``train``  platform — 12 knobs (the Hadoop analog)
  - ``serve``  platform — 11 knobs (the Spark analog)

Every knob is a real ``RunConfig`` field consumed by the distribution layer
(sharding rules, step builders, kernels); none are decorative. Like the
paper's spaces, some knobs matter enormously for a given job and some are
long-tail (e.g. ``attn_block_q`` only binds on the Pallas path — the tuner
has to *discover* that, just as the paper's Table VII shows
``spark.scheduler.listenerbus`` moving nothing).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import RunConfig


@dataclass(frozen=True)
class Param:
    name: str
    default: Any

    def grid(self, num: int) -> List[Any]:
        raise NotImplementedError

    def sample(self, rng, lo=None, hi=None) -> Any:
        raise NotImplementedError

    def snap(self, value) -> Any:
        return value

    @property
    def numeric(self) -> bool:
        return False


@dataclass(frozen=True)
class IntParam(Param):
    lo: int = 0
    hi: int = 1
    step: int = 1
    pow2: bool = False  # snap to powers of two (mesh factors, block sizes)

    @property
    def numeric(self) -> bool:
        return True

    def _valid(self, v: int) -> int:
        v = int(round(v))
        v = max(self.lo, min(self.hi, v))
        if self.pow2:
            # nearest power of two within bounds
            import math

            if v <= 0:
                return max(self.lo, 1) if self.lo > 0 else 0
            p = 2 ** round(math.log2(max(v, 1)))
            return int(max(self.lo, min(self.hi, p)))
        if self.step > 1:
            v = self.lo + round((v - self.lo) / self.step) * self.step
            v = max(self.lo, min(self.hi, v))
        return int(v)

    def snap(self, value) -> int:
        return self._valid(value)

    def grid(self, num: int) -> List[int]:
        if self.pow2:
            vals, v = [], max(self.lo, 1)
            while v <= self.hi:
                vals.append(v)
                v *= 2
            if self.lo == 0:
                vals = [0] + vals
            return vals[:: max(len(vals) // num, 1)] if num < len(vals) else vals
        if num <= 1:
            return [self.default]
        step = max((self.hi - self.lo) / (num - 1), self.step)
        out, v = [], float(self.lo)
        while v <= self.hi + 1e-9:
            out.append(self._valid(v))
            v += step
        return sorted(set(out))

    def grid_between(self, lo: float, hi: float, step: float) -> List[int]:
        out, v = [], lo
        guard = 0
        while v <= hi + 1e-9 and guard < 64:
            out.append(self._valid(v))
            v += max(step, 1e-9)
            guard += 1
        return sorted(set(out))

    def sample(self, rng, lo=None, hi=None) -> int:
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        return self._valid(lo + rng.random() * (hi - lo))


@dataclass(frozen=True)
class FloatParam(Param):
    lo: float = 0.0
    hi: float = 1.0
    step: float = 0.1

    @property
    def numeric(self) -> bool:
        return True

    def snap(self, value) -> float:
        """Clamp into bounds AND quantize to the ``step`` grid anchored at
        ``lo`` (matching ``IntParam.snap`` — the paper samples continuous
        parameters 'with a predefined step', so CRS/TPE proposals must land
        on the same grid the sweeps walk). A quantum that rounds past ``hi``
        clamps back to ``hi``."""
        v = float(max(self.lo, min(self.hi, value)))
        if self.step > 0:
            v = self.lo + round((v - self.lo) / self.step) * self.step
            v = float(max(self.lo, min(self.hi, v)))
        return v

    def grid(self, num: int) -> List[float]:
        if num <= 1:
            return [self.default]
        step = (self.hi - self.lo) / (num - 1)
        # step-quantized snapping can collapse neighbours — dedupe like IntParam
        return sorted({self.snap(self.lo + i * step) for i in range(num)})

    def grid_between(self, lo: float, hi: float, step: float) -> List[float]:
        out, v, guard = [], lo, 0
        while v <= hi + 1e-9 and guard < 64:
            out.append(self.snap(v))
            v += max(step, 1e-9)
            guard += 1
        return sorted(set(out))

    def sample(self, rng, lo=None, hi=None) -> float:
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        return self.snap(lo + rng.random() * (hi - lo))


@dataclass(frozen=True)
class CatParam(Param):
    choices: Tuple[Any, ...] = ()

    def grid(self, num: int) -> List[Any]:
        return list(self.choices)

    def snap(self, value):
        return value if value in self.choices else self.default

    def sample(self, rng, lo=None, hi=None):
        return self.choices[int(rng.random() * len(self.choices)) % len(self.choices)]


def BoolParam(name: str, default: bool) -> CatParam:
    return CatParam(name, default, choices=(False, True))


@dataclass(frozen=True)
class TunableSpace:
    """A platform's curated knob set (paper Table I / Table II analog)."""

    platform: str
    params: Tuple[Param, ...]
    most_influential: Tuple[str, ...]  # the paper's finer-tuning set

    def __post_init__(self):
        names = [p.name for p in self.params]
        assert len(set(names)) == len(names)
        for m in self.most_influential:
            assert m in names, m

    def param(self, name: str) -> Param:
        return next(p for p in self.params if p.name == name)

    def names(self) -> List[str]:
        return [p.name for p in self.params]

    def defaults(self) -> Dict[str, Any]:
        return {p.name: p.default for p in self.params}

    def snap(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {k: self.param(k).snap(v) for k, v in config.items()}

    def to_run_config(self, config: Dict[str, Any], base: Optional[RunConfig] = None) -> RunConfig:
        base = base or RunConfig()
        fields = {f.name for f in dataclasses.fields(RunConfig)}
        overrides = {k: v for k, v in config.items() if k in fields}
        return base.replace(**overrides)


# ---------------------------------------------------------------- the spaces

# Training platform — the "Hadoop 12" (paper Table I analog).
TRAIN_SPACE = TunableSpace(
    platform="train",
    params=(
        IntParam("mesh_model_parallel", 16, lo=1, hi=64, pow2=True),
        IntParam("microbatch_size", 0, lo=0, hi=128, pow2=True),
        CatParam("remat_policy", "full", choices=("none", "dots", "full")),
        IntParam("attn_block_q", 512, lo=128, hi=2048, step=128),
        IntParam("attn_block_kv", 512, lo=128, hi=2048, step=128),
        CatParam("matmul_precision", "bf16", choices=("bf16", "f32")),
        CatParam("grad_compression", "off", choices=("off", "int8")),
        BoolParam("scan_layers", True),
        CatParam("zero_sharding", "fsdp", choices=("none", "zero1", "fsdp")),
        CatParam("collective_matmul", "ag", choices=("ag", "rs")),
        BoolParam("moe_expert_parallel", True),
        CatParam("optimizer_moment_dtype", "float32", choices=("float32", "bfloat16")),
    ),
    most_influential=("mesh_model_parallel", "microbatch_size"),
)

# Serving platform — the "Spark 11" (paper Table II analog).
SERVE_SPACE = TunableSpace(
    platform="serve",
    params=(
        IntParam("mesh_model_parallel", 16, lo=1, hi=64, pow2=True),
        CatParam("kv_cache_dtype", "bfloat16", choices=("bfloat16", "int8")),
        CatParam("kv_partition", "auto", choices=("auto", "heads", "sequence")),
        IntParam("attn_block_kv", 512, lo=128, hi=2048, step=128),
        IntParam("attn_block_q", 512, lo=128, hi=2048, step=128),
        CatParam("weight_dtype", "bfloat16", choices=("bfloat16", "int8")),
        CatParam("matmul_precision", "bf16", choices=("bf16", "f32")),
        BoolParam("scan_layers", True),
        BoolParam("moe_expert_parallel", True),
        CatParam("collective_matmul", "ag", choices=("ag", "rs")),
        CatParam("embed_impl", "gather", choices=("gather", "one_hot")),
    ),
    most_influential=("mesh_model_parallel", "attn_block_kv"),
)

SPACES = {"train": TRAIN_SPACE, "serve": SERVE_SPACE}
