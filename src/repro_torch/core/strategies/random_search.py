"""Pure random search — the streaming baseline proposer.

Unlike the round-based strategies (CRS draws a round before consuming any
result; TPE refills per acquisition round), random search has no round
structure at all: ``ask(n)`` draws the next ``n`` fresh configurations on
demand, so an asynchronous driver can keep every worker busy without a
refill barrier. That makes it the default *inner* proposer under
:class:`~repro_torch.core.strategies.asha.AshaStrategy` — and a useful control in
strategy shootouts (any model-based proposer should beat it).

The proposal stream is a pure function of ``seed``: draws consume the rng in
ask order and de-duplication is by the canonical config key of *proposed*
configs only (never by results), so two runs with the same seed propose the
same sequence regardless of completion order or parallelism.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.core.scheduler import Trial, config_key
from repro_torch.core.space import TunableSpace
from repro_torch.core.strategies.base import QueueStrategy, register_strategy


@dataclass
class RandomResult:
    best_config: Optional[Dict[str, Any]]
    best_time: float
    evaluations: int
    proposals: int
    timeouts: int = 0
    stopped_early: bool = False


@register_strategy("random")
class RandomStrategy(QueueStrategy):
    tag = "random"
    budget_kwarg = "max_trials"

    def __init__(
        self,
        space: TunableSpace,
        *,
        fixed: Optional[Dict[str, Any]] = None,
        max_trials: int = 48,
        seed: int = 0,
    ):
        super().__init__()
        self.space = space
        self.fixed = dict(fixed or {})
        self.max_trials = int(max_trials)
        self.rng = random.Random(seed)
        self._proposed = 0
        self._seen: set = set()
        self.best_config: Optional[Dict[str, Any]] = None
        self.best_time = float("inf")

    def _draw(self) -> Dict[str, Any]:
        cfg = {p.name: p.sample(self.rng) for p in self.space.params}
        return {**cfg, **self.fixed}

    def ask(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        budget = self.max_trials - self._proposed
        want = budget if n is None else min(int(n), budget)
        out: List[Dict[str, Any]] = []
        attempts = 0
        while len(out) < want and attempts < max(50, want * 50):
            attempts += 1
            cfg = self._draw()
            key = config_key(cfg)
            if key in self._seen:
                continue  # tiny spaces exhaust; keep drawing, bounded above
            self._seen.add(key)
            out.append(cfg)
        self._proposed += len(out)
        self._outstanding += len(out)
        return out

    @property
    def done(self) -> bool:
        return self._finished or (
            self._proposed >= self.max_trials and self._outstanding <= 0
        )

    # -- QueueStrategy hooks

    def _observe(self, trial: Trial) -> None:
        if trial.score < self.best_time:
            self.best_time = trial.score
            self.best_config = dict(trial.config)

    def _on_batch_done(self) -> None:
        if self._proposed >= self.max_trials:
            self._finished = True

    def result(self) -> RandomResult:
        return RandomResult(
            best_config=self.best_config,
            best_time=self.best_time,
            evaluations=0,  # stamped by the scheduler (run delta)
            proposals=self._proposed,
        )
