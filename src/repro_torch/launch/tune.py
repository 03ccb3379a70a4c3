"""Engine flags shared by the tuning drivers, and the Study they open.

The reference's ``launch/tune.py`` also holds the train/serve/wordcount
tuning CLI (``main``) and its roofline helpers; the port keeps only the
engine plumbing that ``launch/kernel_tune.py`` needs, each function a
verbatim copy of the reference's. The rest comes with the slices that port
the roofline and WordCount evaluators (ROADMAP Queue 1).
"""
import argparse
from pathlib import Path

from repro_torch.core import EngineConfig, Study


def add_engine_args(ap: argparse.ArgumentParser):
    """Engine knobs shared by every driver that runs the TrialScheduler.
    They populate one validated EngineConfig (see ``engine_config``)."""
    ap.add_argument("--study", type=Path, default=None,
                    help="Study directory owning cache + log + session "
                         "provenance (created on first use; replaces the "
                         "ad-hoc --cache/--log pair)")
    # engine flags default to None (= "not given") so an explicitly-typed
    # value — even one equal to the engine default, like --jobs 1 — is
    # distinguishable and can override a persistent study's stored engine
    ap.add_argument("--jobs", type=int, default=None,
                    help="parallel trials per batch (thread pool; default 1)")
    ap.add_argument("--batch", type=int, default=None,
                    help="max configs per ask() batch (default: whole phase)")
    ap.add_argument("--cache", type=Path, default=None,
                    help="persistent JSONL evaluation cache shared across "
                         "runs (ignored when --study is given)")
    ap.add_argument("--patience", type=int, default=None,
                    help="stop when best hasn't improved in N batches")
    ap.add_argument("--trial-timeout", "--timeout", dest="trial_timeout",
                    type=float, default=None,
                    help="per-trial timeout in seconds (timeout => infeasible; "
                         "hard SIGKILL under --isolation subprocess)")
    ap.add_argument("--retries", type=int, default=None,
                    help="per-trial retries before recording a failure "
                         "(default 0)")
    ap.add_argument("--isolation", default=None,
                    choices=["inline", "subprocess"],
                    help="trial execution backend: inline threads (soft "
                         "timeouts, the default) or worker processes (hard "
                         "deadlines, crash containment, warm reuse)")
    ap.add_argument("--pin-devices", dest="pin_devices", type=int, default=None,
                    help="restrict each subprocess worker to ONE of N device "
                         "slots (env set before the worker's first jax "
                         "import), so N workers run N truly concurrent "
                         "device trials; requires --isolation subprocess")
    ap.add_argument("--prefilter", default=None, choices=["off", "static"],
                    help="static feasibility gate at propose time: 'static' "
                         "rejects provably-doomed configs (clamp aliases, "
                         "VMEM/HBM overflow) as infeasible_static records "
                         "without spawning a worker (default off)")
    ap.add_argument("--surrogate", default=None, choices=["off", "rank"],
                    help="learned cost surrogate over the study cache: "
                         "'rank' makes TPE over-sample acquisition "
                         "candidates and propose only the model-predicted "
                         "frontier, training on local + sibling-cell "
                         "observations (default off)")


def engine_overrides(args) -> dict:
    """EngineConfig fields for exactly the engine flags the user typed."""
    flag_to_field = {
        "jobs": "workers",
        "isolation": "isolation",
        "trial_timeout": "timeout_s",
        "retries": "retries",
        "patience": "patience",
        "batch": "batch_size",
        "pin_devices": "pin_devices",
        "prefilter": "prefilter",
        "surrogate": "surrogate",
    }
    return {
        field: getattr(args, flag)
        for flag, field in flag_to_field.items()
        if getattr(args, flag, None) is not None
    }


def engine_config(args) -> EngineConfig:
    """One validated EngineConfig from the CLI engine flags (engine defaults
    fill anything the user didn't type)."""
    return EngineConfig(**engine_overrides(args))


def open_persistent_study(path: Path, overrides: dict) -> Study:
    """Open (or create) the study at ``path``, overlaying exactly the engine
    flags the CLI user typed onto the study's stored engine — an untyped
    flag never resets a stored knob (e.g. hard subprocess deadlines the
    study was configured with), while an explicit flag always wins, even at
    its default value. Shared by every ``--study``-taking driver."""
    if (Path(path) / Study.MANIFEST).exists():
        study = Study.load(path)
        if overrides:
            study.engine = study.engine.replace(**overrides)
        return study
    return Study.create(path, engine=EngineConfig(**overrides))


def open_study(args, engine: EngineConfig) -> Study:
    """``--study DIR`` opens (or creates) a persistent Study; without it an
    in-memory Study wraps the legacy --cache/--log files."""
    if args.study:
        return open_persistent_study(args.study, engine_overrides(args))
    return Study(engine=engine, cache_path=args.cache,
                 log_path=getattr(args, "log", None))
