"""Learned cost surrogate: ridge regression over the Study cache.

The static half of the ROADMAP's cost-surrogate item shipped earlier
(``--prefilter static``: reject configs whose AOT-estimated peak bytes
exceed HBM, zero devices touched). This module is the learned half, after
Bao's learning-based tuner (PAPERS.md, arXiv:1808.06008): a regression
model trained on *measured* trials predicts wall time for *unmeasured*
configs, and TPE uses it to pre-rank its acquisition candidates — each
model round over-samples proposals, the surrogate re-ranks them, and only
the predicted frontier is evaluated (``--surrogate rank``).

Design constraints, in priority order:

  - **Dependency-free and deterministic.** Pure-Python ridge regression
    (Gaussian elimination, no numpy in the fit path) so the proposal
    stream stays a pure function of (seed, observations, siblings,
    training set) — the transfer purity tests extend to ``--surrogate rank``.
  - **Cross-cell by construction.** Training rows carry their cache
    namespace; a per-namespace intercept column absorbs each cell's scale
    offset (wc:2m is ~2x wc:1m at every config), so sibling cells donate
    *config-effect* evidence without their absolute times poisoning the
    local ranking. This is the transfer machinery in model form:
    siblings arrive through ``Study.histories_for`` even when the Parzen
    ``--transfer`` prior is off.
  - **Log-space everywhere.** The target is ``log(time_s)`` (config
    effects on runtime are multiplicative), pow2 knobs are encoded in
    log2 space (matching TPE's ``_NumericDensity`` metric), and cell
    geometry enters as log2 chips/seq_len/global_batch from the parsed
    :class:`~repro_torch.core.transfer.CellKey`.

The surrogate never touches budget accounting: training is free (it reads
observations the scheduler already paid for), and ranking only *reorders*
candidates within a round — it neither proposes nor suppresses
evaluations, so ``--surrogate rank`` and ``off`` spend identical budgets.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.space import Param, TunableSpace
from repro_torch.core.transfer import parse_namespace

__all__ = [
    "SURROGATE_MODES",
    "CostSurrogate",
    "encode_config",
    "cell_features",
    "hlo_features",
]

SURROGATE_MODES = ("off", "rank")

# Fewest usable rows before the model trusts itself; below this, ``fit``
# leaves the surrogate un-ready and TPE falls back to plain EI order.
MIN_TRAIN = 8


def _log2_metric(param: Param) -> bool:
    """Same rule as TPE's ``_NumericDensity``: pow2 knobs with positive
    bounds live in log2 space."""
    return bool(getattr(param, "pow2", False)) and getattr(param, "lo", 0) >= 1


def encode_config(space: TunableSpace, config: Dict[str, Any]) -> Dict[str, float]:
    """One config -> named numeric features. Numeric knobs become one
    column each (log2 for pow2 knobs), categorical/bool knobs one-hot over
    their declared choices. Missing knobs fall back to the space default so
    foreign-but-compatible cache records still encode."""
    feats: Dict[str, float] = {}
    for p in space.params:
        v = config.get(p.name, p.default)
        if p.numeric:
            x = float(v)
            if _log2_metric(p):
                x = math.log2(max(x, 1.0))
            feats[f"cfg:{p.name}"] = x
        else:
            feats[f"cfg:{p.name}={p.snap(v)!r}"] = 1.0
    return feats


def cell_features(namespace: str) -> Dict[str, float]:
    """Shape-geometry features from a cache namespace via
    :func:`~repro_torch.core.transfer.parse_namespace`: log2 topology always,
    log2 seq/batch + kind one-hot when the shape is a known
    ``configs.base.SHAPES`` cell. Unknown shapes contribute geometry only
    through the per-namespace intercept the model adds separately."""
    key = parse_namespace(namespace)
    feats = {"geo:log2_chips": math.log2(max(key.chips, 1))}
    if key.shape is not None:
        from repro_torch.configs.base import SHAPES

        shape = SHAPES.get(key.shape)
        if shape is not None:
            feats["geo:log2_seq"] = math.log2(shape.seq_len)
            feats["geo:log2_batch"] = math.log2(shape.global_batch)
            feats[f"geo:kind={shape.kind}"] = 1.0
    return feats


def hlo_features(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Optional static-analysis features for one lowered program: peak
    memory from :func:`hlo.parse_memory` and wire traffic from
    :func:`hlo.parse_collectives`, both in log2 bytes (zero traffic -> 0).
    Costs one AOT lowering, no compile, no devices — the same trick (and
    the same HLO-text extraction) as the static prefilter's
    :func:`~repro_torch.core.feasibility.aot_memory_estimate`. Feed the result
    through ``CostSurrogate``'s ``extra_features`` hook."""
    raise NotImplementedError(
        "hlo_features lowers a jax program; the port's compile-time analyses "
        "come in the last slice (ROADMAP Queue 1 item 10)"
    )


def _solve(a: List[List[float]], b: List[float]) -> List[float]:
    """Gaussian elimination with partial pivoting on the (symmetric
    positive-definite, thanks to the ridge) normal equations."""
    n = len(b)
    m = [row[:] + [b[i]] for i, row in enumerate(a)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(m[r][col]))
        if abs(m[piv][col]) < 1e-12:
            continue  # degenerate column; its weight stays 0
        m[col], m[piv] = m[piv], m[col]
        inv = 1.0 / m[col][col]
        for r in range(col + 1, n):
            f = m[r][col] * inv
            if f:
                for c in range(col, n + 1):
                    m[r][c] -= f * m[col][c]
    x = [0.0] * n
    for r in range(n - 1, -1, -1):
        if abs(m[r][r]) < 1e-12:
            continue
        s = m[r][n] - sum(m[r][c] * x[c] for c in range(r + 1, n))
        x[r] = s / m[r][r]
    return x


class CostSurrogate:
    """Ridge regression ``log(time_s) ~ config + cell geometry [+ HLO]``.

    ``fit`` takes ``(config, time_s, namespace)`` rows — the local cell's
    observations plus any sibling cells' — and is a no-op (``ready`` stays
    False) below ``min_train`` usable rows, so early rounds degrade to
    plain TPE rather than rank on noise. Everything is deterministic:
    feature columns are sorted by name, ties in ``rank`` keep input order.
    """

    def __init__(
        self,
        space: TunableSpace,
        *,
        l2: float = 1.0,
        min_train: int = MIN_TRAIN,
        extra_features: Optional[Callable[[Dict[str, Any]], Dict[str, float]]] = None,
    ):
        self.space = space
        self.l2 = float(l2)
        self.min_train = int(min_train)
        self.extra_features = extra_features
        self.ready = False
        self.n_rows = 0
        self._keys: List[str] = []
        self._mean: List[float] = []
        self._scale: List[float] = []
        self._w: List[float] = []
        self._y_mean = 0.0

    def _featurize(self, config: Dict[str, Any], namespace: str) -> Dict[str, float]:
        feats = encode_config(self.space, config)
        feats.update(cell_features(namespace))
        if namespace:
            # per-cell fixed effect: absorbs each cell's absolute scale so
            # siblings teach config *effects*, not their own magnitudes
            feats[f"ns:{namespace}"] = 1.0
        if self.extra_features is not None:
            for k, v in self.extra_features(config).items():
                feats[str(k)] = float(v)
        return feats

    def fit(
        self, rows: Sequence[Tuple[Dict[str, Any], float, str]]
    ) -> "CostSurrogate":
        usable = [
            (cfg, float(t), str(ns))
            for cfg, t, ns in rows
            if math.isfinite(float(t)) and float(t) > 0.0
        ]
        self.ready = False
        self.n_rows = len(usable)
        if len(usable) < self.min_train:
            return self
        feats = [self._featurize(cfg, ns) for cfg, _, ns in usable]
        self._keys = sorted({k for f in feats for k in f})
        d = len(self._keys)
        x = [[f.get(k, 0.0) for k in self._keys] for f in feats]
        y = [math.log(t) for _, t, _ in usable]
        n = len(x)
        self._mean = [sum(col) / n for col in zip(*x)]
        self._scale = []
        for j in range(d):
            var = sum((row[j] - self._mean[j]) ** 2 for row in x) / n
            self._scale.append(math.sqrt(var) if var > 1e-12 else 1.0)
        z = [
            [(row[j] - self._mean[j]) / self._scale[j] for j in range(d)]
            for row in x
        ]
        self._y_mean = sum(y) / n
        yc = [v - self._y_mean for v in y]
        # normal equations with ridge: (Z'Z + l2*I) w = Z'y
        a = [[0.0] * d for _ in range(d)]
        for row in z:
            for j in range(d):
                rj = row[j]
                if rj:
                    arow = a[j]
                    for k in range(j, d):
                        arow[k] += rj * row[k]
        for j in range(d):
            for k in range(j):
                a[j][k] = a[k][j]
            a[j][j] += self.l2
        b = [
            sum(z[i][j] * yc[i] for i in range(n)) for j in range(d)
        ]
        self._w = _solve(a, b)
        self.ready = True
        return self

    def predict(self, config: Dict[str, Any], namespace: str = "") -> float:
        """Predicted ``log(time_s)`` — comparable across configs of one
        cell (absolute accuracy is not the contract; ranking is)."""
        if not self.ready:
            raise RuntimeError("CostSurrogate.predict before a successful fit")
        f = self._featurize(config, namespace)
        return self._y_mean + sum(
            self._w[j] * (f.get(k, 0.0) - self._mean[j]) / self._scale[j]
            for j, k in enumerate(self._keys)
        )

    def rank(
        self, configs: Sequence[Dict[str, Any]], namespace: str = ""
    ) -> List[Dict[str, Any]]:
        """Configs sorted fastest-predicted-first; stable, so equal
        predictions keep the acquisition order they arrived in."""
        if not self.ready:
            return list(configs)
        scored = [(self.predict(c, namespace), i) for i, c in enumerate(configs)]
        return [configs[i] for _, i in sorted(scored, key=lambda si: (si[0], si[1]))]
