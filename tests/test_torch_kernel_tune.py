"""The port's kernel tuner on the CPU: the evaluator, its numerics gate, the
``kernel-cuda/`` namespace, the tuned table and the CLI end to end.

On the CPU the kernels' entry points run their plain torch versions, so
these tests drive every line of the tuner but time nothing of the card;
``chip_smoke.py`` runs the same CLI on the H100.
"""
import hashlib
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernel_tune import DEFAULT_SHAPES as REF_DEFAULT_SHAPES
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref
from repro_torch import kernels
from repro_torch.core import kernel_tune as kt
from repro_torch.core.transfer import parse_namespace
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.launch import kernel_tune as cli

REPO = Path(__file__).resolve().parent.parent
REF_TABLE = REPO / "src" / "repro" / "kernels" / "tuned_table.json"
PORT_TABLE = REPO / "src" / "repro_torch" / "kernels" / "tuned_table.json"


def _ev(kernel="ssm_scan", shape=(2, 128, 64, 8), dtype="f32", **kw):
    kw.setdefault("repeats", 2)
    return kt.make_kernel_evaluator(kernel, shape, dtype, device="cpu", **kw)


def _np(x):
    return x.detach().float().cpu().numpy()


def _rel(a, r):
    a, r = np.asarray(a, np.float32), np.asarray(r, np.float32)
    return float(np.abs(a - r).max() / np.abs(r).max())


# ----------------------------------------------------------------- identity


def test_platform_key_is_the_ports_namespace():
    ev = _ev()
    assert ev.platform_key() == "kernel-cuda/ssm_scan.f32:b2s128di64n8"
    assert kt.parse_kernel_platform(ev.platform_key()) == ("ssm_scan", "f32", "b2s128di64n8")
    with pytest.raises(ValueError, match="kernel-cuda"):
        kt.parse_kernel_platform("kernel/ssm_scan.f32:b2s128di64n8")
    flash = kt.kernel_platform_key("flash_attention", torch.bfloat16,
                                   kt.shape_class_for("flash_attention", (4, 2048, 32, 8, 64)))
    assert flash == "kernel-cuda/flash_attention.bf16:b4s2048h32k8d64"


def test_default_shapes_are_the_references():
    assert kt.DEFAULT_SHAPES == REF_DEFAULT_SHAPES


def test_kernel_similarity_keeps_kernels_and_dtypes_apart():
    a = parse_namespace("kernel-cuda/ssm_scan.f32:b2s128di64n8")
    b = parse_namespace("kernel-cuda/ssm_scan.f32:b1s256di64n16")
    c = parse_namespace("kernel-cuda/ssm_scan.bf16:b2s128di64n8")
    d = parse_namespace("kernel-cuda/flash_attention.f32:b2s256h4k2d64")
    assert kt.kernel_similarity(a, b) == pytest.approx(1 + 1 + 1)
    assert kt.kernel_similarity(a, a) == 0
    assert math.isinf(kt.kernel_similarity(a, c))
    assert math.isinf(kt.kernel_similarity(a, d))


@pytest.mark.parametrize("dh", fa_kernel.HEAD_DIMS)
def test_flash_space_is_the_compiled_tiles(dh):
    """Every point of the Hopper flash space is a compiled tile pair within
    the shared-memory budget at every head dim, and a fixed point of the
    ops-layer snap (no two points alias at a full sequence)."""
    space = kt.KERNEL_SPACES["flash_attention"]
    points = [(bq, bkv) for bq in space.params[0].grid(100) for bkv in space.params[1].grid(100)]
    assert sorted(points) == [(32, 32), (32, 64), (64, 32), (64, 64)]
    for bq, bkv in points:
        assert fa_ops.smem_footprint(bq, bkv, dh) <= fa_ops.SMEM_LIMIT
        assert fa_ops.snap_block(bq, 2048, dh) == bq
        assert fa_ops.snap_block(bkv, 2048, dh) == bkv


# ---------------------------------------------------------------- evaluator


def test_evaluator_ok_path_gives_a_finite_time():
    ev = _ev()
    t, info = ev({"chunk": 32, "d_block": 16})
    assert math.isfinite(t) and t > 0
    assert "numerics_mismatch" not in info
    assert info["timer"] == "perf_counter" and info["device"] == "cpu"
    assert info["repeats"] == 2 and info["spread_s"] >= 0
    assert info["max_rel_err"] <= 1e-4 and info["tol_excess"] <= 1.0
    assert ev.parallel_safe is False
    assert ev.spec.target == "repro_torch.core.kernel_tune:make_kernel_evaluator"


def test_fidelity_scales_the_repeats():
    ev = _ev(repeats=4)
    _, info = ev({"chunk": 64, "d_block": 32}, fidelity=0.5)
    assert info["repeats"] == 2 and info["fidelity"] == 0.5
    _, info = ev({"chunk": 64, "d_block": 32}, fidelity=0.01)
    assert info["repeats"] == 1


def test_inputs_are_built_once_and_dropped_when_pickled():
    import pickle

    ev = _ev()
    data = ev._materialize()
    assert ev._materialize() is data
    clone = pickle.loads(pickle.dumps(ev))
    assert clone._data is None
    for a, b in zip(clone._materialize()[:5], data[:5]):
        assert torch.equal(a, b)  # same seed, same numbers


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 3e-2)])
def test_ssm_oracle_equals_the_references(dtype, tol):
    """The evaluator's oracle output on its own inputs equals the
    reference's ``ssm_scan_ref`` on the same numbers (through numpy)."""
    ev = _ev(dtype=dtype)
    *inputs, ref, _ = ev._materialize()
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jref = jax_ssm_ref(*(jnp.asarray(_np(x), dtype=jdt) for x in inputs))
    assert _rel(_np(ref), np.asarray(jref, np.float32)) < tol


def test_flash_oracle_equals_the_references():
    ev = _ev("flash_attention", (2, 256, 4, 2, 64))
    q, k, v, ref, _ = ev._materialize()
    jref = jax_attention_ref(*(jnp.asarray(_np(x)) for x in (q, k, v)),
                             causal=True, scale=1.0)
    assert _rel(_np(ref), np.asarray(jref, np.float32)) < 1e-5


@pytest.mark.parametrize("kernel,shape,dtype,config", [
    ("ssm_scan", (2, 128, 64, 8), "bf16", {"chunk": 16, "d_block": 1024}),
    ("flash_attention", (2, 256, 4, 2, 64), "bf16", {"block_q": 32, "block_kv": 64}),
    ("flash_attention", (1, 200, 4, 1, 64), "f32", {"block_q": 64, "block_kv": 32}),
])
def test_correct_variants_pass_the_elementwise_gate(kernel, shape, dtype, config):
    t, info = _ev(kernel, shape, dtype)(config)
    assert math.isfinite(t), info
    assert 0 <= info["tol_excess"] <= 1.0


def _ssm_skipping_a_chunk(first, length):
    """The plain version with the state update skipped for ``length`` steps
    from ``first``: y there is read from a stale state."""
    def mutant(dt, u, b_t, c_t, a):
        dtf, uf, bf, cf, af = (x.float() for x in (dt, u, b_t, c_t, a))
        b, s, di = dt.shape
        h = torch.zeros((b, di, af.shape[1]))
        y = torch.empty((b, s, di))
        for t in range(s):
            if not first <= t < first + length:
                h = (torch.exp(dtf[:, t, :, None] * af) * h
                     + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :])
            y[:, t] = (h * cf[:, t, None, :]).sum(-1)
        return y.to(dt.dtype)
    return mutant


def test_ssm_mutant_is_a_numerics_mismatch(monkeypatch):
    """One 16-step chunk of state updates skipped late in the sequence. The
    reference's formula alone reads max|a-b|/max|ref| ≈ 0.73 on it; the port's
    gate rejects it on both tests."""
    ev = _ev(dtype="bf16")
    monkeypatch.setattr(ssm_kernel, "ssm_scan_plain", _ssm_skipping_a_chunk(96, 16))
    t, info = ev({"chunk": 16, "d_block": 64})
    assert t == math.inf and info["numerics_mismatch"] is True
    assert info["tol_excess"] > 1.0
    assert info["max_rel_err"] > kt._DEFAULT_TOL["bf16"]


def test_flash_mutant_passes_the_references_formula_but_not_the_gate(monkeypatch):
    """The mutant skips KV tile 10 for query tiles from 1536 on (S 2048, bf16).
    Late rows average over ~2000 keys, so their outputs are small and the
    missing tile moves them little against max|ref| (row 0 is v_0 itself):
    the reference's formula alone reads under 3e-2 and would let it become
    the incumbent. The element-wise bound catches it."""
    real_bounds = fa_kernel._bounds

    def dropping_tile_10(q_start, *args, **kwargs):
        tiles = real_bounds(q_start, *args, **kwargs)
        return [i for i in tiles if not (q_start >= 1536 and i == 10)]

    ev = _ev("flash_attention", (1, 2048, 4, 1, 64), "bf16", repeats=1)
    t, info = ev({"block_q": 64, "block_kv": 64})
    assert math.isfinite(t) and info["tol_excess"] <= 1.0
    monkeypatch.setattr(fa_kernel, "_bounds", dropping_tile_10)
    t, info = ev({"block_q": 64, "block_kv": 64})
    assert info["max_rel_err"] < kt._DEFAULT_TOL["bf16"]
    assert t == math.inf and info["numerics_mismatch"] is True
    assert info["tol_excess"] > 10.0


def test_non_finite_output_is_a_numerics_mismatch(monkeypatch):
    monkeypatch.setattr(ssm_kernel, "ssm_scan_plain",
                        lambda dt, *a: torch.full_like(dt, float("nan")))
    t, info = _ev()({"chunk": 16, "d_block": 16})
    assert t == math.inf and info["numerics_mismatch"] is True


def test_a_failing_variant_is_an_error_trial(monkeypatch, tmp_path):
    """A kernel that raises inside a trial is an error trial, as in the
    reference's scheduler: never a quiet time."""
    from repro_torch.core.study import Study

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ssm_kernel, "ssm_scan_plain", boom)
    ev = _ev()
    with Study.create(tmp_path / "s") as study:
        out = study.optimize(ev.platform_key(), "random", ev,
                             space=kt.KERNEL_SPACES["ssm_scan"], budget=3, seed=0)
    assert out.best_time == math.inf and not out.best_config
    recs = [json.loads(line) for line in (tmp_path / "s" / "trials.jsonl").read_text().splitlines()]
    assert recs and all(r["status"] == "error" and "launch failed" in r["error"] for r in recs)


def test_clear_caches_hook_reaches_the_evaluator(tmp_path):
    """EngineConfig.clear_caches calls the evaluator's own clear_caches()
    between trials (the reference dropped jax's caches there)."""
    from repro_torch.core.study import EngineConfig, Study

    class Counting:
        parallel_safe = False
        cleared = 0

        def clear_caches(self):
            Counting.cleared += 1

        def __call__(self, config):
            return 1.0 + config["chunk"] / 1000, {}

    with Study.create(tmp_path / "s", engine=EngineConfig(clear_caches=True)) as study:
        out = study.optimize("kernel-cuda/x.f32:b1", "random", Counting(),
                             space=kt.KERNEL_SPACES["ssm_scan"], budget=4, seed=0)
    assert Counting.cleared == out.evaluations >= 4


# -------------------------------------------------------------- tuned table


def test_write_tuned_entries_merges_and_invalidates(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    cls = "b1s40di48n8"
    monkeypatch.setenv(kernels.TUNED_TABLE_ENV, str(path))
    kernels.invalidate_tuned_table_cache()
    assert kernels.tuned_config("ssm_scan", "f32", cls) is None
    kt.write_tuned_entries(kt.tuned_entry("ssm_scan", "f32", cls,
                                          {"chunk": 32, "d_block": 16, "x": 1}, 0.5, "t"), path)
    # the loader cache was dropped: the very next lookup sees the entry
    assert kernels.tuned_config("ssm_scan", "f32", cls) == {"chunk": 32, "d_block": 16}
    kt.write_tuned_entries(kt.tuned_entry("flash_attention", "f32", "b1s64h2k1d64",
                                          {"block_q": 32, "block_kv": 64}, 0.1, "t"), path)
    raw = json.loads(path.read_text())
    assert raw["version"] == kernels._TABLE_VERSION == 1
    assert sorted(raw["entries"]) == ["flash_attention|f32|b1s64h2k1d64", f"ssm_scan|f32|{cls}"]
    kernels.invalidate_tuned_table_cache()


# --------------------------------------------------------------------- CLI


def _digest(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() else None


def test_cli_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The reference's DEFAULT_SHAPES for ssm_scan, CRS, --device cpu: a
    cold run measures, a warm run replays everything, the table lands under
    tmp_path, and selective_scan with no knobs picks its entry up. Neither
    the reference's shipped table nor the port's default one is touched."""
    before = _digest(REF_TABLE), _digest(PORT_TABLE)
    table = tmp_path / "table.json"
    argv = ["--kernel", "ssm_scan", "--strategy", "crs", "--m", "4", "--k", "2",
            "--rounds", "1", "--repeats", "1", "--device", "cpu",
            "--study", str(tmp_path / "study"), "--write-table", str(table)]
    assert cli.main(argv) == 0
    cold = json.loads(capsys.readouterr().out)
    assert sorted(cold["cells"]) == sorted(
        kt.kernel_platform_key("ssm_scan", "f32", kt.shape_class_for("ssm_scan", s))
        for s in kt.DEFAULT_SHAPES["ssm_scan"])
    assert cold["cache_stats"]["fresh"] > 0
    assert cold["tuned_table"] == str(table)
    assert cold["tuned_entries"] == ["ssm_scan|f32|b1s256di64n16", "ssm_scan|f32|b2s128di64n8"]
    for cell in cold["cells"].values():
        assert math.isfinite(cell["best_time_s"]) and cell["evaluations"] >= 1
    assert cli.main(argv) == 0
    warm = json.loads(capsys.readouterr().out)
    assert warm["cache_stats"]["fresh"] == 0
    assert warm["cache_stats"]["cache_hits"] == cold["cache_stats"]["fresh"]

    entries = json.loads(table.read_text())["entries"]
    want = entries["ssm_scan|f32|b2s128di64n8"]["config"]
    monkeypatch.setenv(kernels.TUNED_TABLE_ENV, str(table))
    kernels.invalidate_tuned_table_cache()
    seen = {}

    def spy(*args, chunk, d_block):
        seen.update(chunk=chunk, d_block=d_block)
        return ssm_kernel.ssm_scan_plain(*args)

    monkeypatch.setattr(ssm_ops, "ssm_scan", spy)
    x = [torch.zeros(2, 128, 64), torch.zeros(2, 128, 64), torch.zeros(2, 128, 8),
         torch.zeros(2, 128, 8), torch.zeros(64, 8)]
    ssm_ops.selective_scan(*x)
    assert seen == {"chunk": ssm_ops.snap_chunk(want["chunk"], 128),
                    "d_block": ssm_ops.snap_d_block(want["d_block"], 64)}
    kernels.invalidate_tuned_table_cache()
    assert (_digest(REF_TABLE), _digest(PORT_TABLE)) == before


@pytest.mark.parametrize("flags,match", [
    (["--kernel", "rwkv6"], "--kernel rwkv6"),
    ([], "--kernel all"),  # the reference's default
    (["--kernel", "all"], "--kernel all"),
    (["--kernel", "ssm_scan", "--strategy", "asha"], "--strategy asha"),
    (["--kernel", "ssm_scan", "--isolation", "subprocess"], "--isolation subprocess"),
    (["--kernel", "ssm_scan", "--pin-devices", "2"], "--pin-devices"),
    (["--kernel", "ssm_scan", "--prefilter", "static"], "--prefilter static"),
])
def test_cli_raises_for_what_is_not_ported(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(flags + ["--device", "cpu"])


def test_cli_and_evaluator_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--kernel", "ssm_scan"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.KernelEvaluator("ssm_scan", (2, 128, 64, 8))


def test_engine_pieces_that_are_not_ported_raise(tmp_path):
    from repro_torch.core import executors, scheduler, study, surrogate

    cases = [
        (lambda: kt.KernelEvaluator("rwkv6", (2, 160, 3, 32), device="cpu"), "slice 3"),
        (lambda: study.EngineConfig(prefilter="static"), "static prefilter"),
        (lambda: scheduler.TrialScheduler(lambda c: (1.0, {}), prefilter="static"),
         "static prefilter"),
        (lambda: executors.make_backend("subprocess"), "subprocess backend"),
        (lambda: study._space_for("wordcount"), "wordcount"),
        (lambda: study.Study().cell("llama3.2-1b", "train_4k"), "roofline"),
        (lambda: study.StudyCell(None, "llama3.2-1b", "train_4k"), "roofline"),
        (lambda: surrogate.hlo_features(lambda: None), "jax program"),
    ]
    for call, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            call()
    with pytest.raises(ValueError, match="prefilter"):
        study.EngineConfig(prefilter="bogus")
    with pytest.raises(ValueError, match="take"):
        kt.KernelEvaluator("ssm_scan", (2, 128, 64, 8), dtype="f16", device="cpu")
