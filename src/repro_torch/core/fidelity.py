"""Fidelity — the resource axis multi-fidelity strategies (ASHA) promote
along.

A *fidelity* is a fraction ``0 < f <= 1`` of the full evaluation budget for
one trial: input scale for the measured WordCount job (a prefix of the
corpus), probe depth for the roofline evaluator (skip the second/third
cost-model probes), or whatever a custom ``fidelity``-aware evaluator makes
of it. ``fidelity=1.0`` is — by definition and by construction everywhere in
the engine — byte-identical to the pre-fidelity behaviour: full-fidelity
cache keys, log records, and evaluator calls carry no fidelity marker at
all, so existing caches replay unchanged.

:class:`FidelitySchedule` owns the successive-halving rung geometry
``r0·eta^k``: the cheapest rung is ``min_fidelity``, each promotion
multiplies the budget by ``eta``, and the ladder is clamped to end exactly
at ``max_fidelity`` (the top rung is always the full requested fidelity,
never an overshoot).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

__all__ = ["FidelitySchedule", "full_fidelity"]


def full_fidelity(fidelity: float) -> bool:
    """Whether ``fidelity`` means "the full evaluation" (no marker anywhere)."""
    return fidelity >= 1.0


@dataclass(frozen=True)
class FidelitySchedule:
    """Geometric successive-halving rungs ``min_fidelity · eta^k``.

    ``min_fidelity``  the cheapest rung (fraction of a full evaluation)
    ``max_fidelity``  the top rung — what "winning" costs (usually 1.0)
    ``eta``           promotion factor: each rung is eta× the previous one,
                      and ASHA promotes the top ``1/eta`` of each rung
    """

    min_fidelity: float
    max_fidelity: float = 1.0
    eta: float = 3.0

    def __post_init__(self):
        if not 0.0 < self.min_fidelity <= self.max_fidelity:
            raise ValueError(
                f"need 0 < min_fidelity <= max_fidelity, got "
                f"{self.min_fidelity} / {self.max_fidelity}"
            )
        if self.max_fidelity > 1.0:
            raise ValueError(
                f"max_fidelity must be <= 1.0, got {self.max_fidelity}"
            )
        if not self.eta > 1.0:
            raise ValueError(f"eta must be > 1, got {self.eta}")

    def rungs(self) -> List[float]:
        """Ascending rung fidelities; the last entry is exactly
        ``max_fidelity``. A geometric step that would overshoot the top is
        clamped onto it rather than emitted past it, and a degenerate
        schedule (min == max) is the single-rung ladder — plain full-fidelity
        search."""
        out: List[float] = []
        f = float(self.min_fidelity)
        # bound the ladder length analytically; float drift must not loop
        k_max = int(math.ceil(
            math.log(self.max_fidelity / self.min_fidelity) / math.log(self.eta)
        )) if self.max_fidelity > self.min_fidelity else 0
        for k in range(k_max + 1):
            f = min(self.min_fidelity * self.eta ** k, self.max_fidelity)
            if out and f <= out[-1]:
                break
            out.append(f)
        if out[-1] < self.max_fidelity:
            out.append(self.max_fidelity)
        return out
