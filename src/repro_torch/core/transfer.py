"""Cross-cell transfer: sibling histories, cell similarity, config snapping.

A :class:`~repro_torch.core.study.Study` that has tuned ``train/mamba:1x8`` holds
evidence that should accelerate ``train/mamba:2x8`` — the same observation
that drives learning-based tuners (Bao, arXiv:1808.06008) and the online
transfer setting of arXiv:2309.01901. The per-cell platform namespacing that
keeps cells from *corrupting* each other's caches also keeps that evidence
out; this module is the sanctioned way back in:

  - :func:`parse_namespace` decodes the ``{train|serve}/arch:shape[@Nc]``
    cache namespaces (topology keying) into a structured :class:`CellKey`,
  - :func:`default_similarity` scores two cells by (arch, shape, chips)
    distance — pluggable: ``Study.histories_for(similarity=...)`` takes any
    ``(CellKey, CellKey) -> float`` (``inf`` = never a sibling),
  - :class:`SiblingHistory` is what ``histories_for`` returns and what the
    ``Strategy.on_study_attach(history, siblings=...)`` channel carries,
  - :func:`snap_into_space` lands a sibling cell's config inside another
    cell's :class:`~repro_torch.core.space.TunableSpace` — in-bounds, on-grid,
    idempotent (the property tests enforce all three).

Transfer modes (the ``--transfer`` CLI flag / ``Study.optimize(transfer=)``):

  ``off``    no sibling channel (the default — cells tune from scratch)
  ``warm``   sibling *incumbents* seed the strategy's initial candidate set
             (cheap; gsft/crs use this, tpe seeds its startup batch)
  ``prior``  sibling *observations* enter TPE's Parzen densities with a
             distance-decayed weight; they never count toward ``max_trials``
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.space import TunableSpace

__all__ = [
    "TRANSFER_MODES",
    "CellKey",
    "SiblingHistory",
    "Similarity",
    "default_similarity",
    "parse_namespace",
    "snap_into_space",
    "warm_seed_configs",
]

TRANSFER_MODES = ("off", "warm", "prior")

DEFAULT_CHIPS = 256  # namespaces only carry @Nc when non-default


@dataclass(frozen=True)
class CellKey:
    """Structured identity of one cache namespace: ``base`` is the space
    name (``train``/``serve``/``wordcount``), arch/shape the cell coordinates
    (None for un-celled namespaces like plain ``wordcount``), chips the
    topology (default 256 — the ``@Nc`` suffix is only present otherwise)."""

    base: str
    arch: Optional[str] = None
    shape: Optional[str] = None
    chips: int = DEFAULT_CHIPS


def parse_namespace(namespace: str) -> CellKey:
    """Decode a cache namespace into a :class:`CellKey`.

    Accepts every namespace shape the drivers write: ``train``,
    ``wordcount/variant``, ``train/arch:shape``, ``train/arch:shape@512c``.
    """
    base, sep, cell = namespace.partition("/")
    if not sep:
        return CellKey(base=base)
    chips = DEFAULT_CHIPS
    if "@" in cell:
        cell, _, suffix = cell.rpartition("@")
        digits = suffix[:-1] if suffix.endswith("c") else suffix
        try:
            chips = int(digits)
        except ValueError:
            cell = f"{cell}@{suffix}"  # not a chips suffix; keep it in the name
    arch, colon, shape = cell.partition(":")
    return CellKey(
        base=base,
        arch=arch or None,
        shape=(shape or None) if colon else None,
        chips=chips,
    )


def _shape_distance(a: Optional[str], b: Optional[str]) -> float:
    """Distance between two shape names: 0 for identical, a log-scaled
    sequence/batch gap (+ a kind-mismatch step) for known shapes, a flat
    step when either side is unknown."""
    if a == b:
        return 0.0
    if a is None or b is None:
        return 0.5
    from repro_torch.configs.base import SHAPES

    sa, sb = SHAPES.get(a), SHAPES.get(b)
    if sa is None or sb is None:
        return 1.0
    d = 0.0 if sa.kind == sb.kind else 1.0
    d += abs(math.log2(sa.seq_len) - math.log2(sb.seq_len)) * 0.25
    d += abs(math.log2(sa.global_batch) - math.log2(sb.global_batch)) * 0.25
    return d


def default_similarity(a: CellKey, b: CellKey) -> float:
    """Distance between two cells; smaller = more similar, ``inf`` = never a
    sibling. Different base platforms are incomparable (their spaces differ);
    otherwise arch identity dominates, then shape geometry, then topology."""
    if a.base != b.base:
        return math.inf
    d = 0.0
    if a.arch != b.arch:
        d += 1.0
    d += _shape_distance(a.shape, b.shape)
    d += abs(math.log2(max(a.chips, 1)) - math.log2(max(b.chips, 1))) * 0.25
    return d


Similarity = Callable[[CellKey, CellKey], float]


@dataclass(frozen=True)
class SiblingHistory:
    """One sibling cell's evidence: its cache namespace, its similarity
    distance to the receiving cell, and its ``(config, time_s, tag)`` trial
    triples in cache (first-write) order — the order is load-bearing: resume
    replays a recorded *prefix* of it to reproduce the original sibling set.
    """

    namespace: str
    distance: float
    trials: Tuple[Tuple[Dict[str, Any], float, Any], ...]

    @property
    def weight(self) -> float:
        """Distance-decayed influence in [0, 1]: ``exp(-distance)``."""
        return math.exp(-float(self.distance))

    def incumbent(self) -> Optional[Dict[str, Any]]:
        """The sibling's best finite-time config (None when it has none)."""
        best_cfg, best_t = None, math.inf
        for cfg, t, _tag in self.trials:
            if math.isfinite(t) and t < best_t:
                best_cfg, best_t = cfg, t
        return dict(best_cfg) if best_cfg is not None else None


def snap_into_space(space: TunableSpace, config: Dict[str, Any]) -> Dict[str, Any]:
    """Land a (possibly foreign) config inside ``space``: every param of the
    space gets a value — the config's own where present, the space default
    otherwise — snapped in-bounds and on-grid through ``Param.snap``, with
    keys the space doesn't know dropped. Defaults are snapped too (a shipped
    default may sit off its own step grid, e.g. wordcount's ``io_sort_mb``
    100 on a 32-step grid), so the result is always a ``snap`` fixed point
    and the function is idempotent."""
    return {
        p.name: p.snap(config[p.name] if p.name in config else p.default)
        for p in space.params
    }


def warm_seed_configs(space, fixed, siblings, existing):
    """The shared ``warm`` seeding step (gsft/crs): each sibling's incumbent,
    snapped into ``space`` with ``fixed`` re-applied, deduped against
    ``existing`` pending configs and each other — in sibling (closest-first)
    order."""
    from repro_torch.core.scheduler import config_key

    seen = {config_key(c) for c in existing}
    seeds = []
    for sib in siblings:
        inc = sib.incumbent()
        if inc is None:
            continue
        cfg = {**snap_into_space(space, inc), **(fixed or {})}
        key = config_key(cfg)
        if key not in seen:
            seen.add(key)
            seeds.append(cfg)
    return seeds
