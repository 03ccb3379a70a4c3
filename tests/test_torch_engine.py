"""The port's tuning engine is the reference's, copied.

Each engine module of ``src/repro_torch/core`` (and the kernel-tune CLI) is
the reference's file with ``repro.`` renamed to ``repro_torch.`` (and its
comments' PR citations reworded by one rule) plus the hunks listed here,
each with a one-line reason. The copy guard rebuilds each
port file from the reference text and those hunks and requires it to be
byte-identical: any other drift fails, so a review of the engine reads only
this list. The differential tests then run GSFT, CRS, TPE and random search
through ``Study.optimize`` in both packages on one deterministic objective
and require the same proposals, incumbents, cache keys and trial records.
"""
import ast
import hashlib
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "src" / "repro"
PORT = REPO / "src" / "repro_torch"

# The port's sources cite no PR numbers: the reference's citations in
# comments are reworded by one rule for every module (regex -> replacement).
CITATIONS = [
    (r"shipped in PR \d+", "shipped earlier"),
    (r"the PR \d+ purity tests", "the transfer purity tests"),
    (r"the PR \d+ transfer machinery", "the transfer machinery"),
    (r"the PR \d+ static prefilter", "the static prefilter"),
    (r"\(PR-\d+(?:'s topology)? keying\)", "(topology keying)"),
    (r" \(PR-\d+\)", ""),
]
NOT_PORTED = "raises NotImplementedError naming the slice that ports it"

# module -> [(old, new, reason)]. ``old`` is a string found exactly once in
# the renamed reference text, or a (start, end) pair of such strings: the
# span from ``start`` up to ``end`` (None: the end of the file) is replaced.
HUNKS = {
    "core/space.py": [],
    "core/fidelity.py": [],
    "core/strategies/base.py": [],
    "core/strategies/gsft.py": [],
    "core/strategies/crs.py": [],
    "core/strategies/random_search.py": [],
    "core/strategies/tpe.py": [],
    "core/scheduler.py": [
        ('''            from repro_torch.core.feasibility import make_prefilter

            prefilter = make_prefilter(prefilter)''',
         '''            if prefilter != "off":
                raise NotImplementedError(
                    f"prefilter={prefilter!r}: the port has no static "
                    "prefilter yet (ROADMAP Queue 1, the static prefilter "
                    "for kernel-cuda/ cells)"
                )
            prefilter = None''',
         "the static prefilter (core/feasibility.py) is not ported: " + NOT_PORTED),
    ],
    "core/executors.py": [
        ('''    return None


# -------------------------------------------------------------- worker child
''', '''    return None


def _clear_caches(evaluator: Any) -> None:
    """Between-trial cache clearing: the evaluator's own ``clear_caches()``
    when it has one, nothing otherwise (the port runs no jax, so there is no
    global compile cache to drop)."""
    clear = getattr(evaluator, "clear_caches", None)
    if callable(clear):
        clear()


# -------------------------------------------------------------- worker child
''', "the hook that replaces jax.clear_caches() at the three sites below"),
        ('''        if clear_caches:
            try:
                import jax

                jax.clear_caches()
            except Exception:  # noqa: BLE001 — evaluator may not use jax
                pass
        t0 = time.time()''', '''        if clear_caches:
            _clear_caches(evaluator)
        t0 = time.time()''', "worker: the evaluator clears its own caches"),
        ('''        if s.clear_caches:
            import jax

            out = []
            for k, c in plan:
                jax.clear_caches()''', '''        if s.clear_caches:
            out = []
            for k, c in plan:
                _clear_caches(s.evaluator)''', "inline batch: the same hook"),
        ('''        if s.clear_caches:
            try:
                import jax

                jax.clear_caches()
            except Exception:  # noqa: BLE001 — evaluator may not use jax
                pass
        run.started''', '''        if s.clear_caches:
            _clear_caches(s.evaluator)
        run.started''', "inline async path: the same hook"),
        ('''    if name in ("subprocess", "process"):
        return SubprocessBackend(**options)''', '''    if name in ("subprocess", "process"):
        raise NotImplementedError(
            "isolation='subprocess': the port's subprocess backend, with a "
            "torch.cuda.device_count() pin check, comes in a later slice "
            "(ROADMAP Queue 1)"
        )''', "the subprocess backend needs a torch pin check first: " + NOT_PORTED),
    ],
    "core/strategies/__init__.py": [
        ('''Registered: ``gsft``/``grid`` (Algorithm I), ``crs`` (Algorithm II),
``hillclimb`` (curated §Perf moves), ``tpe``/``bayes`` (Tree-structured
Parzen Estimator with batched acquisition), ``random`` (streaming baseline),
``asha`` (asynchronous successive halving over any inner proposer). New''',
         '''Registered: ``gsft``/``grid`` (Algorithm I), ``crs`` (Algorithm II),
``tpe``/``bayes`` (Tree-structured Parzen Estimator with batched
acquisition), ``random`` (streaming baseline); ``asha`` and ``hillclimb``
come in later slices of the port (ROADMAP Queue 1). New''',
         "docstring: the strategies this slice registers"),
        ("from repro_torch.core.strategies.asha import AshaResult, AshaStrategy, AsyncJob\n",
         "", "asha is not ported"),
        ('''from repro_torch.core.strategies.hillclimb import (
    CuratedHillclimbStrategy,
    HillclimbResult,
    Move,
)
''', "", "hillclimb is not ported"),
        ('''    "AshaResult",
    "AshaStrategy",
    "AsyncJob",
''', "", "asha's exports"),
        ('''    "CuratedHillclimbStrategy",
''', "", "hillclimb's exports"),
        ('''    "HillclimbResult",
    "Move",
''', "", "hillclimb's exports"),
    ],
    "core/transfer.py": [],
    "core/surrogate.py": [
        (('''    import jax

    from repro_torch.core.hlo import''', "\n\n\ndef _solve("),
         '''    raise NotImplementedError(
        "hlo_features lowers a jax program; the port's compile-time analyses "
        "come in the last slice (ROADMAP Queue 1 item 10)"
    )''', "hlo_features lowers with jax: " + NOT_PORTED),
    ],
    "core/study.py": [
        ('''        from repro_torch.core.feasibility import PREFILTER_MODES
''', '''        PREFILTER_MODES = ("off", "static")  # the reference's feasibility.py
''', "core/feasibility.py is not ported; its mode names stay valid"),
        ('''                f"got {self.prefilter!r}"
            )
''', '''                f"got {self.prefilter!r}"
            )
        if self.prefilter != "off":
            raise NotImplementedError(
                f"EngineConfig.prefilter={self.prefilter!r}: the port has no "
                "static prefilter yet (ROADMAP Queue 1, the static prefilter "
                "for kernel-cuda/ cells)"
            )
''', "the static prefilter: " + NOT_PORTED),
        ('''        from repro_torch.apps.wordcount import WORDCOUNT_SPACE

        return WORDCOUNT_SPACE''', '''        raise NotImplementedError(
            "the wordcount space comes with the port of apps/wordcount.py "
            "(ROADMAP Queue 1 item 7)"
        )''', "the wordcount space: " + NOT_PORTED),
        (('''        key = f"{arch}:{shape}"
        cell = self._cells.get(key)''', "    # ------------------------------------------------------------ accessors"),
         '''        raise NotImplementedError(
            "Study.cell builds roofline cells; they come with the port's "
            "compile-time analyses (ROADMAP Queue 1 item 10)"
        )

''', "Study.cell is the roofline slice's: " + NOT_PORTED),
        ('''        # perf observability: the process-wide probe-compile cache counters
        # (lazy import — report() must not pay the roofline/jax import for
        # studies that never touched a roofline evaluator)
        from repro_torch.core.roofline import probe_cache_stats

''', '''        # the port runs no roofline probe compiles: core/roofline.py comes
        # with the compile-time analyses (ROADMAP Queue 1 item 10)
''', "report() keeps its shape; the port has no probe-compile cache to count"),
        ('"probe_cache": probe_cache_stats(),', '"probe_cache": None,',
         "report(): no probe-compile cache (see above)"),
        (('''    """One (arch × shape) cell of a tuning matrix, bound to a study.''', None),
         '''    """One (arch × shape) roofline cell of a tuning matrix, bound to a study:
    the port's roofline slice brings it (ROADMAP Queue 1 item 10)."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "StudyCell runs the roofline evaluator; it comes with the port's "
            "compile-time analyses (ROADMAP Queue 1 item 10)"
        )
''', "StudyCell is the roofline slice's: " + NOT_PORTED),
    ],
    "core/__init__.py": [
        ('''  - ``cmpe``       — back-compat serial CMPE facade over the scheduler
  - ``strategies`` — ask/tell Strategy engine: gsft, crs, hillclimb, tpe
  - ``grid_finer`` — Algorithm I wrapper: Grid Search with Finer Tuning (§VIII)
  - ``crs``        — Algorithm II wrapper: Controlled Random Search (§IX)
''', '''  - ``strategies`` — ask/tell Strategy engine: gsft, crs, tpe, random
''', "docstring: the modules this slice ports"),
        ('''  - ``tuner``      — the Admin facade (Figure I) — deprecated shim over Study
  - ``evaluators`` — walltime (paper-faithful) / roofline (AOT) backends
  - ``roofline``   — TPU v5e roofline terms from compiled artifacts
  - ``hlo``        — collective-traffic parser over partitioned HLO
''', '''  - ``kernel_tune`` — the H100 kernels as Study workloads

The reference's ``cmpe``, ``grid_finer``/``crs`` wrappers, ``tuner``,
``evaluators``, ``roofline``, ``hlo``, ``feasibility`` and the ``asha`` and
``hillclimb`` strategies come in later slices of the port (ROADMAP Queue 1).
''', "docstring: what is left out"),
        ('''from repro_torch.core.cmpe import CMPE, best_from_log, read_log
from repro_torch.core.crs import CRSResult, controlled_random_search
''', "", "cmpe and the crs wrapper are not ported"),
        ("from repro_torch.core.grid_finer import GridResult, grid_search_finer_tuning\n",
         "", "the grid_finer wrapper is not ported"),
        ('''    CRSStrategy,
    CuratedHillclimbStrategy,
    GridFinerStrategy,
    HillclimbResult,
    Move,
''', '''    CRSStrategy,
    GridFinerStrategy,
''', "hillclimb is not ported"),
        ("from repro_torch.core.tuner import tune\n", "", "the tune shim is not ported"),
        ('''    "CMPE",
''', "", "exports of left-out modules"),
        ('''    "CRSResult",
    "CRSStrategy",
    "CuratedHillclimbStrategy",
''', '''    "CRSStrategy",
''', "exports of left-out modules"),
        ('''    "GridResult",
    "HillclimbResult",
''', "", "exports of left-out modules"),
        ('''    "Move",
''', "", "exports of left-out modules"),
        ('''    "best_from_log",
''', "", "exports of left-out modules"),
        ('''    "controlled_random_search",
    "grid_search_finer_tuning",
''', "", "exports of left-out modules"),
        ('''    "read_log",
''', "", "exports of left-out modules"),
        ('''    "register_strategy",
    "tune",
''', '''    "register_strategy",
''', "exports of left-out modules"),
    ],
    "launch/kernel_tune.py": [
        (('"""Kernel autotuning driver', "from __future__ import annotations"),
         '''"""Kernel autotuning driver — turn the Study tuner on the port's CUDA kernels.

One cell per (kernel, dtype, shape-class); each trial launches one kernel
variant on the card (numerics-gated against the ``ref.py`` oracle, then
timed with CUDA events), and the study cache makes warm re-runs free. Tune
the selective scan at the full-width Jamba cell with CRS and write the
incumbent into the port's tuned table, which ``selective_scan`` reads when
the caller passes no knobs:

    PYTHONPATH=src python -m repro_torch.launch.kernel_tune \\
        --kernel ssm_scan --shapes 1x4096x16384x16 --dtype bf16 \\
        --strategy crs --study build/studies/kernels-cuda --write-table

Shapes are ``x``-separated dims per kernel: flash ``B x S x Hq x Hkv x Dh``,
ssm_scan ``B x S x Di x N`` (defaults in ``DEFAULT_SHAPES``). It runs on the
card; ``--device cpu`` runs the kernels' plain torch versions instead (the
CPU tests do). ``--kernel rwkv6``/``all``, ``--strategy asha``,
``--isolation subprocess``, ``--pin-devices`` and ``--prefilter static``
raise until the slices that port them (ROADMAP Queue 1).
"""
''', "docstring: the card, --device, what raises"),
        ("from repro_torch.kernels import DEFAULT_TABLE_PATH\n",
         "from repro_torch.device import resolve_device\n"
         "from repro_torch.kernels import DEFAULT_TABLE_PATH\n",
         "the device is resolved, never guessed"),
        ('''    ap.add_argument("--no-interpret", dest="interpret", action="store_false",
                    help="run compiled kernels on the real accelerator "
                         "instead of interpret mode")''',
         '''    ap.add_argument("--device", default=None,
                    help="where the kernels run: the CUDA card (default; "
                         "raises without one) or 'cpu' for their plain "
                         "torch versions")''', "--device in place of --no-interpret"),
        ('''                         "(default path: the shipped "
                         "src/repro/kernels/tuned_table.json)")''',
         '''                         "(default path: the port's own "
                         "src/repro_torch/kernels/tuned_table.json)")''',
         "help: the port's own table (DEFAULT_TABLE_PATH is the port's)"),
        ('''    args = ap.parse_args(argv)
''', '''    args = ap.parse_args(argv)
    unported = {
        "--kernel rwkv6": args.kernel == "rwkv6",
        "--kernel all": args.kernel == "all",
        "--strategy asha": args.algorithm == "asha",
        "--isolation subprocess": args.isolation == "subprocess",
        "--pin-devices": args.pin_devices is not None,
        "--prefilter static": args.prefilter == "static",
    }
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet: rwkv6 comes with slice 3 of the "
                "port, the others with their own items (ROADMAP Queue 1)"
            )
    device = resolve_device(args.device)
''', "what this slice does not offer: " + NOT_PORTED + "; no GPU raises"),
        ("repeats=args.repeats, interpret=args.interpret,",
         "repeats=args.repeats, device=device,", "the evaluator takes the device"),
    ],
}

# launch/tune.py keeps only these functions of the reference, verbatim
TUNE_FUNCTIONS = ("add_engine_args", "engine_overrides", "engine_config",
                  "open_persistent_study", "open_study")


def _rename(text: str) -> str:
    """The reference text as the port copies it: ``repro.`` renamed, PR
    citations reworded (:data:`CITATIONS`)."""
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    for pattern, replacement in CITATIONS:
        text = re.sub(pattern, replacement, text)
    return text


def _apply(text: str, old, new: str, module: str) -> str:
    if isinstance(old, tuple):
        start, end = old
        assert text.count(start) == 1, (module, start[:60])
        i = text.index(start)
        if end is None:
            return text[:i] + new
        assert text.count(end) == 1, (module, end[:60])
        j = text.index(end)
        assert j > i, (module, start[:60])
        return text[:i] + new + text[j:]
    assert text.count(old) == 1, (module, old[:60], text.count(old))
    return text.replace(old, new)


@pytest.mark.parametrize("module", sorted(HUNKS))
def test_engine_module_is_the_reference_plus_listed_hunks(module):
    expected = _rename((REF / module).read_text())
    for old, new, reason in HUNKS[module]:
        assert reason
        expected = _apply(expected, old, new, module)
    port = (PORT / module).read_text()
    if port != expected:
        import difflib

        diff = "".join(difflib.unified_diff(
            expected.splitlines(True), port.splitlines(True),
            "reference+hunks", "port", n=1))
        pytest.fail(f"{module} drifted from the reference:\n{diff[:4000]}")


def _functions(path: Path):
    src = path.read_text()
    return {n.name: ast.get_source_segment(src, n)
            for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)}


def test_launch_tune_keeps_the_engine_functions_verbatim():
    ref, port = _functions(REF / "launch" / "tune.py"), _functions(PORT / "launch" / "tune.py")
    assert sorted(port) == sorted(TUNE_FUNCTIONS)
    for name in TUNE_FUNCTIONS:
        assert port[name] == _rename(ref[name]), name


def test_every_engine_copy_is_guarded():
    """A new module under the port's core/ is either a guarded copy or the
    one port (kernel_tune.py, whose evaluator is framework code)."""
    port_modules = {str(p.relative_to(PORT)) for p in (PORT / "core").rglob("*.py")}
    assert port_modules - set(HUNKS) == {"core/kernel_tune.py"}


# ------------------------------------------------------ differential engine


class _Objective:
    """A deterministic evaluator, identical in both packages: the time is a
    hash of the config, so every strategy meets a rugged surface and any
    difference in proposals shows up in the records."""

    parallel_safe = True

    def __call__(self, config):
        blob = json.dumps(config, sort_keys=True, default=str).encode()
        h = int(hashlib.sha256(blob).hexdigest()[:8], 16)
        return 0.5 + h / 2.0**32, {"h": h}


def _space(pkg):
    """A two-knob space plus a categorical, built from each package's own
    space.py (the same code after the copy)."""
    space_mod = __import__(f"{pkg}.core.space", fromlist=["x"])
    return space_mod.TunableSpace(
        platform="diff",
        params=(
            space_mod.IntParam("chunk", 128, lo=16, hi=256, pow2=True),
            space_mod.IntParam("d_block", 256, lo=16, hi=1024, pow2=True),
            space_mod.CatParam("layout", "bshd", choices=("bshd", "bhsd")),
        ),
        most_influential=("chunk", "d_block"),
    )


STRATEGY_RUNS = {
    "gsft": dict(samples_per_param=3),
    "crs": dict(m=6, k=2, max_rounds=3, seed=7),
    "tpe": dict(budget=10, seed=7),  # 4 startup draws, then model rounds
    "random": dict(budget=10, seed=7),
}


def _run(pkg, algorithm, study_dir):
    study_mod = __import__(f"{pkg}.core.study", fromlist=["x"])
    kwargs = dict(STRATEGY_RUNS[algorithm])
    budget = kwargs.pop("budget", None)
    with study_mod.Study.create(study_dir) as study:
        cold = study.optimize("kernel-cuda/diff.f32:b1s64", algorithm, _Objective(),
                              space=_space(pkg), budget=budget, **kwargs)
    with study_mod.Study.load(study_dir) as study:
        warm = study.optimize("kernel-cuda/diff.f32:b1s64", algorithm, _Objective(),
                              space=_space(pkg), budget=budget, **kwargs)
    return cold, warm


def _records(path: Path, drop=("ts", "wall_s")):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        for k in drop:
            rec.pop(k, None)
        out.append(rec)
    return out


@pytest.mark.parametrize("algorithm", sorted(STRATEGY_RUNS))
def test_strategies_match_the_reference(algorithm, tmp_path):
    runs = {pkg: _run(pkg, algorithm, tmp_path / pkg) for pkg in ("repro", "repro_torch")}
    (ref_cold, ref_warm), (port_cold, port_warm) = runs["repro"], runs["repro_torch"]
    assert port_cold.best_config == ref_cold.best_config
    assert port_cold.best_time == ref_cold.best_time
    assert port_cold.default_time == ref_cold.default_time
    assert port_cold.evaluations == ref_cold.evaluations > 1
    assert port_cold.cache_stats == ref_cold.cache_stats
    assert port_warm.cache_stats["fresh"] == ref_warm.cache_stats["fresh"] == 0
    assert port_warm.best_config == ref_warm.best_config == ref_cold.best_config
    ref_trials = _records(tmp_path / "repro" / "trials.jsonl")
    port_trials = _records(tmp_path / "repro_torch" / "trials.jsonl")
    assert [r["config"] for r in port_trials] == [r["config"] for r in ref_trials]
    assert port_trials == ref_trials
    ref_keys = [json.loads(line)["key"] for line in
                (tmp_path / "repro" / "cache.jsonl").read_text().splitlines()]
    port_keys = [json.loads(line)["key"] for line in
                 (tmp_path / "repro_torch" / "cache.jsonl").read_text().splitlines()]
    assert port_keys == ref_keys and len(port_keys) == ref_cold.evaluations
    drop = ("ts", "wall_s", "log_path")
    assert (_records(tmp_path / "repro_torch" / "sessions.jsonl", drop)
            == _records(tmp_path / "repro" / "sessions.jsonl", drop))


def test_report_keeps_its_shape(tmp_path):
    from repro.core.study import Study as RefStudy
    from repro_torch.core.study import Study

    reports = {}
    for name, cls in (("repro", RefStudy), ("repro_torch", Study)):
        with cls.create(tmp_path / name) as study:
            study.optimize("kernel-cuda/diff.f32:b1s64", "random", _Objective(),
                           space=_space(name), budget=4, seed=1)
            reports[name] = study.report()
    ref, port = reports["repro"], reports["repro_torch"]
    assert sorted(port) == sorted(ref)
    assert port["best"] == ref["best"]
    assert [{k: v for k, v in r.items() if k != "wall_s"} for r in port["sessions"]] == \
        [{k: v for k, v in r.items() if k != "wall_s"} for r in ref["sessions"]]
    assert port["probe_cache"] is None
