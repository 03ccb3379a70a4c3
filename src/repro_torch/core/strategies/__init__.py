"""Pluggable ask/tell search strategies for the tuning engine.

``make_strategy(name, space, **kwargs)`` builds a registered strategy; the
:class:`~repro_torch.core.scheduler.TrialScheduler` drives it:

    strategy = make_strategy("gsft", space, active_params=[...])
    result = scheduler.run(strategy, batch_size=8, patience=3)

Registered: ``gsft``/``grid`` (Algorithm I), ``crs`` (Algorithm II),
``tpe``/``bayes`` (Tree-structured Parzen Estimator with batched
acquisition), ``random`` (streaming baseline); ``asha`` and ``hillclimb``
come in later slices of the port (ROADMAP Queue 1). New
optimizers register with ``@register_strategy("name")`` and implement
ask/tell — no executor changes.
"""
from repro_torch.core.strategies.base import (
    STRATEGIES,
    QueueStrategy,
    Strategy,
    make_strategy,
    register_strategy,
)
from repro_torch.core.strategies.crs import CRSResult, CRSStrategy
from repro_torch.core.strategies.gsft import GridFinerStrategy, GridResult
from repro_torch.core.strategies.random_search import RandomResult, RandomStrategy
from repro_torch.core.strategies.tpe import TPEResult, TPEStrategy

__all__ = [
    "CRSResult",
    "CRSStrategy",
    "GridFinerStrategy",
    "GridResult",
    "QueueStrategy",
    "RandomResult",
    "RandomStrategy",
    "STRATEGIES",
    "Strategy",
    "TPEResult",
    "TPEStrategy",
    "make_strategy",
    "register_strategy",
]
