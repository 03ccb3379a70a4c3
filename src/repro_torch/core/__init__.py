"""The paper's contribution: auto-tuning of platform configuration parameters.

  - ``space``      — the curated 12-train / 11-serve knob tables (§III)
  - ``scheduler``  — TrialScheduler: batched/cached/pruned trial execution
                     (grown from the paper's CMPE, §VII)
  - ``executors``  — trial isolation backends: inline threads (soft
                     timeouts) / subprocess workers (hard SIGKILL deadlines)
  - ``strategies`` — ask/tell Strategy engine: gsft, crs, tpe, random
  - ``study``      — Study: persistent, resumable tuning sessions + EngineConfig
  - ``transfer``   — cross-cell transfer: sibling histories, cell similarity,
                     config snapping (the ``--transfer off|warm|prior`` modes)
  - ``surrogate``  — learned cost model over the study cache: ridge
                     regression that pre-ranks TPE acquisition candidates
                     (the ``--surrogate off|rank`` modes)
  - ``kernel_tune`` — the H100 kernels as Study workloads

The reference's ``cmpe``, ``grid_finer``/``crs`` wrappers, ``tuner``,
``evaluators``, ``roofline``, ``hlo``, ``feasibility`` and the ``asha`` and
``hillclimb`` strategies come in later slices of the port (ROADMAP Queue 1).
"""
from repro_torch.core.executors import (
    EvaluatorSpec,
    ExecutionBackend,
    InlineBackend,
    SubprocessBackend,
    make_backend,
)
from repro_torch.core.scheduler import Trial, TrialScheduler, config_hash, config_key
from repro_torch.core.space import SERVE_SPACE, SPACES, TRAIN_SPACE, TunableSpace
from repro_torch.core.strategies import (
    CRSStrategy,
    GridFinerStrategy,
    Strategy,
    TPEResult,
    TPEStrategy,
    make_strategy,
    register_strategy,
)
from repro_torch.core.study import EngineConfig, Study, StudyCell, TuneOutcome, run_session
from repro_torch.core.surrogate import SURROGATE_MODES, CostSurrogate
from repro_torch.core.transfer import (
    TRANSFER_MODES,
    CellKey,
    SiblingHistory,
    default_similarity,
    parse_namespace,
    snap_into_space,
)

__all__ = [
    "EngineConfig",
    "Study",
    "StudyCell",
    "run_session",
    "CRSStrategy",
    "EvaluatorSpec",
    "ExecutionBackend",
    "GridFinerStrategy",
    "InlineBackend",
    "SubprocessBackend",
    "SERVE_SPACE",
    "SPACES",
    "Strategy",
    "TPEResult",
    "TPEStrategy",
    "TRAIN_SPACE",
    "Trial",
    "TrialScheduler",
    "TuneOutcome",
    "TunableSpace",
    "TRANSFER_MODES",
    "SURROGATE_MODES",
    "CostSurrogate",
    "CellKey",
    "SiblingHistory",
    "default_similarity",
    "parse_namespace",
    "snap_into_space",
    "config_hash",
    "config_key",
    "make_backend",
    "make_strategy",
    "register_strategy",
]
