"""Streaming serving metrics: per-window latency quantiles and throughput.

A copy of the reference's ``serving/metrics.py`` (the port imports nothing
from ``repro``). The serving driver feeds one latency sample per decode step
into a :class:`DecodeWindowMonitor`; at window boundaries the monitor emits a
:class:`WindowStats` (p50/p99 over the window's sliding reservoir, mean,
tokens/s), which the online controller (a later slice of the port) makes
guard decisions on.

Time never enters this module directly (the ``serving-injected-clock`` lint
rule bans wall-clock reads package-wide): the monitor takes an injectable
``clock=`` callable. With ``clock=None`` a window's wall time is the sum of
its recorded latencies — exactly right for simulations, where the "latency"
samples are scripted and a real clock would destroy determinism. The real
driver injects ``time.perf_counter``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Sequence

__all__ = ["DecodeWindowMonitor", "WindowStats", "quantile"]


def quantile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile over ``values`` (need not be sorted).

    Deterministic and dependency-free (no numpy): ``q`` in [0, 1] maps onto
    rank ``q * (n - 1)`` of the sorted sample with linear interpolation
    between neighbouring order statistics — the same convention as
    ``numpy.quantile``'s default."""
    if not values:
        raise ValueError("quantile of an empty sample")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    ordered = sorted(values)
    pos = q * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    frac = pos - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


@dataclass(frozen=True)
class WindowStats:
    """One decode window's measured behaviour — what guard decisions rank.

    ``p50``/``p99``/``mean``/``max`` are per-token decode latencies in
    seconds over the window's reservoir; ``tokens_per_s`` is the window's
    throughput; ``wall_s`` its wall time (clock delta when a clock is
    injected, sum of latencies otherwise)."""

    window: int
    count: int
    p50: float
    p99: float
    mean: float
    max: float
    tokens_per_s: float
    wall_s: float

    def to_dict(self) -> dict:
        return {
            "window": self.window,
            "count": self.count,
            "p50_s": self.p50,
            "p99_s": self.p99,
            "mean_s": self.mean,
            "max_s": self.max,
            "tokens_per_s": self.tokens_per_s,
            "wall_s": self.wall_s,
        }


class DecodeWindowMonitor:
    """Sliding-window latency/throughput monitor for the decode loop.

    Usage per window::

        monitor.begin_window()
        for each decoded token:
            monitor.record(latency_s, tokens=batch)
        stats = monitor.end_window()

    The per-window reservoir keeps at most ``max_samples`` latencies (oldest
    evicted first — a bounded sliding window, so a pathological window can
    never grow memory without bound); ``history`` retains the last
    ``history_windows`` WindowStats for aggregate reporting."""

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        max_samples: int = 4096,
        history_windows: int = 64,
    ):
        if int(max_samples) < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.clock = clock
        self.max_samples = int(max_samples)
        self.history: Deque[WindowStats] = deque(maxlen=int(history_windows))
        self._samples: Deque[float] = deque(maxlen=self.max_samples)
        self._window = 0
        self._tokens = 0
        self._t_start: Optional[float] = None
        self._open = False

    def begin_window(self) -> None:
        if self._open:
            raise RuntimeError("begin_window() called twice without end_window()")
        self._samples.clear()
        self._tokens = 0
        self._t_start = self.clock() if self.clock is not None else None
        self._open = True

    def record(self, latency_s: float, tokens: int = 1) -> None:
        """One decode-step observation: ``latency_s`` for ``tokens`` new
        tokens (a batched step emits batch-many tokens in one step)."""
        if not self._open:
            raise RuntimeError("record() outside begin_window()/end_window()")
        if latency_s < 0:
            raise ValueError(f"negative latency {latency_s}")
        self._samples.append(float(latency_s))
        self._tokens += int(tokens)

    def end_window(self) -> WindowStats:
        if not self._open:
            raise RuntimeError("end_window() without begin_window()")
        if not self._samples:
            raise RuntimeError("end_window() on a window with no samples")
        samples: List[float] = list(self._samples)
        if self.clock is not None and self._t_start is not None:
            wall = self.clock() - self._t_start
        else:
            wall = sum(samples)
        stats = WindowStats(
            window=self._window,
            count=len(samples),
            p50=quantile(samples, 0.50),
            p99=quantile(samples, 0.99),
            mean=sum(samples) / len(samples),
            max=max(samples),
            tokens_per_s=self._tokens / wall if wall > 0 else 0.0,
            wall_s=wall,
        )
        self.history.append(stats)
        self._window += 1
        self._open = False
        return stats

    def aggregate(self, last_n: Optional[int] = None) -> Optional[WindowStats]:
        """Pooled stats over the last ``last_n`` retained windows (all
        retained windows when None); None when no window has completed.
        Quantiles are weighted by window sample counts via per-window
        (p50, p99) pooling — an *approximation* (exact pooling would need
        the raw samples, which the sliding reservoir has dropped), good
        enough for end-of-run reporting, never used by guard decisions."""
        windows = list(self.history)
        if last_n is not None:
            windows = windows[-int(last_n):]
        if not windows:
            return None
        count = sum(w.count for w in windows)
        wall = sum(w.wall_s for w in windows)
        tokens = sum(w.tokens_per_s * w.wall_s for w in windows)
        return WindowStats(
            window=windows[-1].window,
            count=count,
            p50=quantile([w.p50 for w in windows], 0.50),
            p99=quantile([w.p99 for w in windows], 0.99),
            mean=sum(w.mean * w.count for w in windows) / count,
            max=max(w.max for w in windows),
            tokens_per_s=tokens / wall if wall > 0 else 0.0,
            wall_s=wall,
        )
