#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. print the card's name and power limit (nvidia-smi), build every CUDA
     kernel of ``src/repro_torch`` from source with nvcc for sm_90a;
  2. kernel phase: the flash-attention kernel against its plain torch
     version on the card, element by element (``PLAIN_TOL``), at the serve
     shape and at the edge cases (ragged, window + softcap + MQA, dh 256,
     dh 32, non-causal, kv_length, f32), with the kernel's, the plain
     version's and SDPA's times (CUDA events), and the bound: the larger of
     the matmul operations over the card's peak for the input type and the
     bytes (q, k, v read once, o written once) over its memory rate;
  3. ssm kernel phase: the selective-scan kernel against its plain torch
     version on the card, element by element (``PLAIN_TOL``), at every
     compiled state size N, f32 and bf16, a ragged sequence, d_block above
     di, and the full-width Jamba-1.5-Large cell (B1 S4096 di16384 N16,
     bf16) with the kernel's and the plain version's times and the bound
     (bytes over the memory rate against f32 operations over the CUDA-core
     peak), beside the exponentials' own term;
  4. small-input check: the smoke llama served on the card through the
     kernel gives the same greedy tokens as on the CPU through the plain
     version, at f32;
  5. tuning phase: ``launch/kernel_tune.py``'s ``main`` (the port's CLI) on
     a temporary study and table: GSFT over the flash tiles at the serve
     shape, CRS over the selective scan at the Jamba cell. The launch
     counters are zeroed just before and read just after: each kernel must
     have launched at least once per fresh trial. A warm re-run must measure
     nothing fresh, and with the written table named by
     ``REPRO_TORCH_KERNEL_TUNED_TABLE`` a knob-less ``selective_scan`` must
     launch the tuned config. The environment is restored afterwards;
  6. serve phase: ``launch/serve.py``'s offline path on full-width
     llama3.2-1b (bf16 weights from a seeded generator), batch 4, prompt
     2048, 32 new tokens, attention through the kernel. The launch counters
     are zeroed just before and read just after: the kernel must have run
     16 times per prefill. In one more prefill each layer's kernel output
     is held element-wise (``PLAIN_TOL``) against the plain version on the
     same q/k/v, the model's own activations. The last-token prefill logits
     must be finite and agree with the torch attention path.

The launch counts in the kernels' record are those of each kernel's main
path: flash_fwd's from the serve phase (slice 1), ssm_scan's from the tuning
phase, the only path of the port that reaches it (as in the reference).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, the script fails before printing either.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM, NVIDIA's data sheet: dense peaks and memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: CUDA cores, no tensor cores
HBM_BYTES_PER_S = 3.35e12
# the reference's numerics gate, max|a-b| / max|ref|: SDPA against the plain
# version, and the kernel and torch attention paths of the whole model (held
# only this loosely: bf16 roundings that differ anywhere spread through its
# 16 layers, see PERF.md)
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# kernel against its plain version, element by element: |a-b| <= rtol*|plain|
# + atol. Both do f32 math and differ only in summation order and exp/tanh
# rounding (about 1e-7 absolute at these inputs), so at bf16 an output may
# differ by one rounding step (at most 2^-7 of it) and at f32 by a few ulps
PLAIN_TOL = {"bfloat16": (2.0**-7, 1e-6), "float32": (1e-5, 1e-6)}
SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:117"
SSM_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SSM_REPLACES = "src/repro/kernels/ssm_scan/kernel.py:48"
# exp runs on the special-function units: 16 per SM per clock, 132 SMs at
# the 1.98 GHz boost clock (NVIDIA's H100 SXM data sheet and white paper)
EXP_PER_S = 16 * 132 * 1.98e9

# name, B, S, di, N, dtype, chunk, d_block: every compiled N, both dtypes, a
# ragged last chunk, d_block above di (and not dividing it), the shared-memory
# opt-in above 48 KB, and the full-width Jamba-1.5-Large cell (d_model 8192 x
# ssm_expand 2, state 16)
SSM_CASES = [
    ("n4_ragged", 2, 1000, 96, 4, "bfloat16", 64, 32),
    ("n4_f32", 1, 300, 64, 4, "float32", 256, 1024),
    ("n8_dblock_past_di", 1, 100, 48, 8, "float32", 16, 1024),
    ("n8_bf16", 2, 257, 160, 8, "bfloat16", 32, 128),
    ("n16_unaligned", 2, 300, 200, 16, "bfloat16", 128, 96),
    ("n32_f32", 1, 257, 128, 32, "float32", 256, 64),
    ("n32_bf16", 1, 200, 96, 32, "bfloat16", 16, 32),
    ("n64_smem_optin", 1, 300, 64, 64, "bfloat16", 256, 128),
    ("n64_f32", 1, 150, 100, 64, "float32", 128, 1024),
    ("jamba_full", 1, 4096, 16384, 16, "bfloat16", 128, 256),
]
# the tuning phase's cells (kernel_tune's x-separated shapes)
FLASH_TUNE_SHAPE = "4x2048x32x8x64"
SSM_TUNE_SHAPE = "1x4096x16384x16"

# name, B, S, Hq, Hkv, dh, causal, window, softcap, kv_length, dtype, block_q, block_kv
CASES = [
    ("serve", 4, 2048, 32, 8, 64, True, 0, 0.0, None, "bfloat16", 512, 512),
    ("ragged_s200", 1, 200, 8, 2, 64, True, 0, 0.0, None, "bfloat16", 32, 32),
    ("window_softcap_mqa", 1, 1024, 8, 1, 128, True, 128, 50.0, None, "bfloat16", 64, 32),
    ("dh256", 1, 512, 4, 2, 256, True, 0, 0.0, None, "bfloat16", 64, 64),
    ("dh32", 2, 300, 4, 1, 32, True, 8, 50.0, None, "bfloat16", 32, 64),
    ("non_causal", 2, 512, 8, 8, 64, False, 0, 0.0, None, "bfloat16", 64, 64),
    ("kv_length", 2, 512, 8, 2, 64, False, 0, 0.0, 300, "bfloat16", 64, 64),
    ("f32", 1, 512, 4, 2, 64, True, 0, 0.0, None, "float32", 64, 64),
]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tol_excess(out, ref, rtol: float, atol: float) -> float:
    """max over elements of |out - ref| / (rtol*|ref| + atol): at most 1
    when every element is within the tolerance."""
    a, r = out.float(), ref.float()
    return ((a - r).abs() / (rtol * r.abs() + atol)).max().item()


def rel_to_max(out, ref) -> float:
    a, r = out.float(), ref.float()
    return ((a - r).abs().max() / r.abs().max()).item()


def live_mask(s, t, causal, window, kv_length, device):
    import torch

    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = kpos < (t if kv_length is None else kv_length)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


def kernel_phase(torch, device):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops

    records = {}
    gen = torch.Generator(device=device).manual_seed(0)
    for (name, b, s, hq, hkv, dh, causal, window, cap, kv_len, dtype,
         bq, bkv) in CASES:
        dt = getattr(torch, dtype)
        q = (torch.randn((b, s, hq, dh), generator=gen, device=device) * dh**-0.5).to(dt)
        k = torch.randn((b, s, hkv, dh), generator=gen, device=device).to(dt)
        v = torch.randn((b, s, hkv, dh), generator=gen, device=device).to(dt)
        kw = dict(causal=causal, window=window, kv_length=kv_len)
        run_kernel = lambda: ops.flash_attention(q, k, v, softcap_val=cap, block_q=bq,
                                                 block_kv=bkv, **kw)
        before = fa_kernel.LAUNCHES
        out = run_kernel()
        torch.cuda.synchronize()
        if fa_kernel.LAUNCHES != before + 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        tq, tkv = ops.snap_block(bq, s, dh, dt), ops.snap_block(bkv, s, dh, dt)
        run_plain = lambda: fa_kernel.flash_attention_plain(
            q, k, v, softcap=cap, block_q=tq, block_kv=tkv, scale=1.0, **kw)
        plain = run_plain()
        diff = (out.float() - plain.float()).abs().max().item()
        rel = rel_to_max(out, plain)
        excess = tol_excess(out, plain, *PLAIN_TOL[dtype])
        if not torch.isfinite(out.float()).all() or not excess <= 1.0:
            raise AssertionError(
                f"{name}: kernel vs plain exceeds |a-b| <= rtol*|plain| + atol "
                f"{PLAIN_TOL[dtype]} by {excess}x (max abs err {diff}, "
                f"rel to max {rel})")

        library_ms = None
        if not cap:  # SDPA has no softcap
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = (live_mask(s, s, causal, window, kv_len, device)
                    if window or kv_len is not None else None)
            run_lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                scale=1.0, enable_gqa=hkv != hq)
            lib = run_lib().transpose(1, 2)
            lib_rel = rel_to_max(lib, plain)
            if lib_rel >= TOL[dtype]:
                raise AssertionError(f"{name}: SDPA disagrees with the plain version ({lib_rel})")
            library_ms = cuda_ms(run_lib, iters=20)

        pairs = int(live_mask(s, s, causal, window, kv_len, device).sum().item())
        flops = 4.0 * b * hq * pairs * dh  # QK^T and PV over the live pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        ms = cuda_ms(run_kernel, iters=10)
        plain_ms = cuda_ms(run_plain, iters=2, warmup=1)
        rec = dict(tiles=f"{tq}x{tkv}", tol_excess=excess, rel_to_max=rel,
                   max_abs_err=diff, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   gflop=flops / 1e9, mbytes=nbytes / 1e6)
        records[name] = rec
        print(f"kernel {name}: {json.dumps(rec)}", flush=True)
    return records


def ssm_inputs(torch, gen, b, s, di, n, dtype, device):
    """The kernel tuner's distributions: softplus Δ, N(0,1) u, B and C, and
    A = -exp(0.3·z)."""
    dt = getattr(torch, dtype)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return [torch.nn.functional.softplus(normal(b, s, di)).to(dt), normal(b, s, di).to(dt),
            normal(b, s, n).to(dt), normal(b, s, n).to(dt),
            (-torch.exp(0.3 * normal(di, n))).to(dt)]


def ssm_phase(torch, device):
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel

    records = {}
    gen = torch.Generator(device=device).manual_seed(1)
    for name, b, s, di, n, dtype, chunk, d_block in SSM_CASES:
        x = ssm_inputs(torch, gen, b, s, di, n, dtype, device)
        run_kernel = lambda: ssm_kernel.ssm_scan(*x, chunk=chunk, d_block=d_block)
        before = ssm_kernel.LAUNCHES
        out = run_kernel()
        torch.cuda.synchronize()
        if ssm_kernel.LAUNCHES != before + 1:
            raise AssertionError(f"ssm {name}: the kernel was not launched")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = ssm_kernel.ssm_scan_plain(*x)
        end.record()
        torch.cuda.synchronize()
        diff = (out.float() - plain.float()).abs().max().item()
        excess = tol_excess(out, plain, *PLAIN_TOL[dtype])
        rec = dict(chunk=chunk, d_block=d_block, tol_excess=excess,
                   rel_to_max=rel_to_max(out, plain), max_abs_err=diff)
        if out.shape != (b, s, di) or not torch.isfinite(out.float()).all() or not excess <= 1.0:
            raise AssertionError(
                f"ssm {name}: kernel vs plain exceeds |a-b| <= rtol*|plain| + atol "
                f"{PLAIN_TOL[dtype]} by {excess}x (max abs err {diff})")
        if name == "jamba_full":
            elem = out.element_size()
            nbytes = (3 * b * s * di + 2 * b * s * n + di * n) * elem
            flops = b * s * di * (6 * n + 1)  # dt*a, e*h, du*b, +, h*c, + per n; dt*u
            exps = b * s * di * n
            t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
            rec.update(ms=cuda_ms(run_kernel, iters=10), plain_ms=start.elapsed_time(end),
                       library_ms=None, bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       bytes=nbytes, gflop=flops / 1e9, exp_calls=exps,
                       exp_sfu_ms=exps / EXP_PER_S * 1e3)
        records[name] = rec
        print(f"ssm kernel {name} (B{b} S{s} di{di} N{n} {dtype}): {json.dumps(rec)}",
              flush=True)
    print("ssm_scan library_ms: none (no single PyTorch call computes a selective scan)",
          flush=True)
    return records


def _measured_trials(study_dir: Path, platform: str):
    """The cell's measured trials from the study's trial log, in order:
    config, best-of-repeats ms, spread (slowest minus fastest repeat) ms,
    and the gate's tol_excess."""
    out = []
    for line in (study_dir / "trials.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["platform"] == platform and not rec["cached"]:  # measured, not replayed
            if rec["status"] != "ok" or rec["info"].get("numerics_mismatch"):
                raise AssertionError(f"{platform}: trial failed: {rec}")
            out.append(dict(tag=rec["tag"], config=rec["config"], ms=rec["time_s"] * 1e3,
                            spread_ms=rec["info"]["spread_s"] * 1e3,
                            tol_excess=rec["info"]["tol_excess"]))
    return out


def tuning_phase(torch, device, scratch: Path):
    """The kernel tuner's CLI on the card: GSFT over the flash tiles, CRS
    over the selective scan, a warm re-run, and the table read back."""
    import contextlib
    import io
    import os

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.launch import kernel_tune

    study, table = scratch / "study", scratch / "tuned_table.json"
    runs = [
        ("flash_fwd", fa_kernel, ["--kernel", "flash_attention", "--shapes", FLASH_TUNE_SHAPE,
                                  "--dtype", "bf16", "--strategy", "gsft", "--repeats", "5"]),
        ("ssm_scan", ssm_kernel, ["--kernel", "ssm_scan", "--shapes", SSM_TUNE_SHAPE,
                                  "--dtype", "bf16", "--strategy", "crs", "--m", "6", "--k",
                                  "2", "--rounds", "2", "--repeats", "3"]),
    ]

    def tune(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = kernel_tune.main(argv + ["--study", str(study), "--write-table", str(table)])
        if rc != 0:
            raise AssertionError(f"kernel_tune {argv} exited {rc}")
        return json.loads(buf.getvalue())

    launches = {}
    for name, module, argv in runs:
        fa_kernel.LAUNCHES = ssm_kernel.LAUNCHES = 0
        report = tune(argv)
        launches[name] = module.LAUNCHES
        (platform, cell), = report["cells"].items()
        fresh = report["cache_stats"]["fresh"]
        if not fresh or module.LAUNCHES < fresh:
            raise AssertionError(f"tune {name}: {module.LAUNCHES} launches for {fresh} "
                                 f"fresh trials")
        if not cell["best_time_s"] < float("inf") or not cell["best_config"]:
            raise AssertionError(f"tune {name}: no feasible incumbent: {cell}")
        trials = _measured_trials(study, platform)
        spread = {json.dumps(t["config"], sort_keys=True): t["spread_ms"] for t in trials}
        rec = dict(platform=platform, default_ms=cell["default_time_s"] * 1e3,
                   default_spread_ms=next(t["spread_ms"] for t in trials
                                          if t["tag"] == "default"),
                   best_ms=cell["best_time_s"] * 1e3, reduction_pct=cell["reduction_pct"],
                   best_config=cell["best_config"],
                   best_spread_ms=spread[json.dumps(cell["best_config"], sort_keys=True)],
                   evaluations=cell["evaluations"], cache=report["cache_stats"],
                   launches=module.LAUNCHES, trials=trials)
        print(f"tune {name} cold: {json.dumps(rec)}", flush=True)
    for name, module, argv in runs:
        before = module.LAUNCHES
        report = tune(argv)
        if report["cache_stats"]["fresh"] != 0 or module.LAUNCHES != before:
            raise AssertionError(f"tune {name} warm re-run measured again: "
                                 f"{report['cache_stats']}")
        print(f"tune {name} warm: cache {json.dumps(report['cache_stats'])}", flush=True)

    entries = json.loads(table.read_text())["entries"]
    b, s, di, n = (int(d) for d in SSM_TUNE_SHAPE.split("x"))
    want = entries[kernels.table_key("ssm_scan", "bf16",
                                     kernels.ssm_shape_class((b, s, di), n))]["config"]
    saved = os.environ.get(kernels.TUNED_TABLE_ENV)
    os.environ[kernels.TUNED_TABLE_ENV] = str(table)
    kernels.invalidate_tuned_table_cache()
    try:
        x = ssm_inputs(torch, torch.Generator(device=device).manual_seed(2), b, s, di, n,
                       "bfloat16", device)
        y = ssm_ops.selective_scan(*x)
        torch.cuda.synchronize()
    finally:
        if saved is None:
            os.environ.pop(kernels.TUNED_TABLE_ENV, None)
        else:
            os.environ[kernels.TUNED_TABLE_ENV] = saved
        kernels.invalidate_tuned_table_cache()
    expect = {"chunk": ssm_ops.snap_chunk(want["chunk"], s),
              "d_block": ssm_ops.snap_d_block(want["d_block"], di)}
    if ssm_kernel.LAST_LAUNCH != expect or not torch.isfinite(y.float()).all():
        raise AssertionError(f"selective_scan with no knobs launched "
                             f"{ssm_kernel.LAST_LAUNCH}, the table holds {want}")
    print(f"tuned table round trip: selective_scan with no knobs launched "
          f"{json.dumps(ssm_kernel.LAST_LAUNCH)} from the table", flush=True)
    torch.cuda.empty_cache()
    return launches


def small_input_phase(torch, device):
    """Smoke llama at f32: the kernel path on the card and the plain path on
    the CPU, same weights and prompts, give the same greedy tokens."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.launch import serve
    from repro_torch.serving.metrics import DecodeWindowMonitor

    run = RunConfig(matmul_precision="f32", attention_impl="kernel")
    arch = get_arch("llama3.2-1b", smoke=True)
    model = make_prefill_step(arch, run).model
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = model.init_params(gen, torch.device("cpu"))
    tokens = torch.randint(0, arch.vocab_size, (2, 40), generator=gen)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    ids = {}
    for dev in ("cpu", str(device)):
        args = argparse.Namespace(arch=arch.name, smoke=True, batch=2, prompt_len=40,
                                  max_new=8, window_steps=4, device=dev)
        ids[dev] = serve._measured_serve(run, args, DecodeWindowMonitor(),
                                         params=to(params, dev), tokens=tokens)[2].cpu()
    cpu_ids, gpu_ids = ids["cpu"], ids[str(device)]
    if gpu_ids.cpu().tolist() != cpu_ids.tolist():
        raise AssertionError(f"smoke greedy ids differ: card {gpu_ids.tolist()} "
                             f"cpu {cpu_ids.tolist()}")
    print(f"small input: smoke llama greedy ids identical on card and cpu "
          f"({gpu_ids.shape[0]}x{gpu_ids.shape[1]})", flush=True)


def serve_phase(torch, device):
    from repro_torch.configs.archs import get_arch
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    from repro_torch.serving.metrics import DecodeWindowMonitor

    args = argparse.Namespace(arch="llama3.2-1b", smoke=False, batch=4, prompt_len=2048,
                              max_new=32, window_steps=8, device=str(device))
    arch = get_arch(args.arch)
    run = RunConfig(attention_impl="kernel")  # bf16 weights and compute
    prefill = make_prefill_step(arch, run)
    gen = torch.Generator(device=device).manual_seed(0)
    params = prefill.model.init_params(gen, device)
    tokens = torch.randint(0, arch.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    monitor = DecodeWindowMonitor(clock=time.perf_counter)

    fa_kernel.LAUNCHES = 0
    t_prefill, t_decode, ids = serve._measured_serve(run, args, monitor, params=params,
                                                     tokens=tokens)
    launches = fa_kernel.LAUNCHES
    prefills = 2  # the untimed warmup and the timed prefill
    if launches != arch.num_layers * prefills:
        raise AssertionError(f"flash kernel launched {launches} times in {prefills} "
                             f"prefills of {arch.num_layers} layers")
    if ids.shape != (args.batch, args.max_new) or not (
            (ids >= 0) & (ids < arch.padded_vocab)).all():
        raise AssertionError(f"generated ids {tuple(ids.shape)} out of range")

    # one more prefill, each layer's kernel output held against the plain
    # version on the q/k/v the model gave it (checked at once: later layers
    # may reuse the buffers)
    launch_kernel, layer_excess = ops.flash_attention_fwd, []

    def checked(q, k, v, **kw):
        out = launch_kernel(q, k, v, **kw)
        plain = fa_kernel.flash_attention_plain(q, k, v, **kw)
        layer_excess.append(tol_excess(out, plain, *PLAIN_TOL[str(q.dtype).removeprefix("torch.")]))
        return out

    before = fa_kernel.LAUNCHES
    ops.flash_attention_fwd = checked
    try:
        logits_kernel, _ = prefill(params, tokens)
    finally:
        ops.flash_attention_fwd = launch_kernel
    if fa_kernel.LAUNCHES - before != arch.num_layers or len(layer_excess) != arch.num_layers:
        raise AssertionError("one prefill did not launch the kernel once per layer")
    logits_torch, _ = make_prefill_step(arch, run.replace(attention_impl="torch"))(params, tokens)
    checks = dict(layer_tol_excess_max=max(layer_excess),
                  logits_vs_torch_rel_to_max=rel_to_max(logits_kernel, logits_torch))
    print(f"serve checks: {json.dumps(checks)}", flush=True)
    if not max(layer_excess) <= 1.0:
        raise AssertionError(f"kernel vs plain on the model's activations, per layer "
                             f"tol_excess {layer_excess}")
    if not (torch.isfinite(logits_kernel.float()).all() and torch.isfinite(logits_torch.float()).all()):
        raise AssertionError("non-finite prefill logits")
    if not checks["logits_vs_torch_rel_to_max"] < TOL["bfloat16"]:
        raise AssertionError(f"kernel vs torch prefill logits differ: {checks}")

    n_new = args.batch * args.max_new
    rec = dict(prefill_s=t_prefill, prefill_tok_s=args.batch * args.prompt_len / t_prefill,
               decode_s=t_decode, decode_tok_s=n_new / t_decode,
               windows=[dict(window=w.window, steps=w.count, p50_ms=w.p50 * 1e3,
                             p99_ms=w.p99 * 1e3, tok_s=w.tokens_per_s)
                        for w in monitor.history],
               launches=launches, **checks)
    print(f"serve llama3.2-1b b{args.batch} prompt {args.prompt_len} new {args.max_new}: "
          f"{json.dumps(rec)}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    device = torch.device("cuda:0")
    # f32 products in full f32 on the card (the f32 case and the small-input
    # check hold the card against f32 references)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build_all()
    for stem in libs:
        _build.library(stem)
    log = "".join(_build.BUILD_LOG.values())
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s"
          + (f"; ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
             f"{spills} bytes of spill stores" if regs else " (cached)"), flush=True)

    records = kernel_phase(torch, device)
    ssm_records = ssm_phase(torch, device)
    small_input_phase(torch, device)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_", dir=ROOT / "build") as scratch:
        tune_launches = tuning_phase(torch, device, Path(scratch))
    launches = serve_phase(torch, device)
    print(f"launches: serve path flash_fwd {launches}; tuning path "
          f"{json.dumps(tune_launches)}", flush=True)

    serve_rec, ssm_rec = records["serve"], ssm_records["jamba_full"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": serve_rec["max_abs_err"],
        "ms": serve_rec["ms"], "plain_ms": serve_rec["plain_ms"],
        "bound_ms": serve_rec["bound_ms"], "bound_by": serve_rec["bound_by"],
        "library_ms": serve_rec["library_ms"],
    }, {
        "name": "ssm_scan", "route": "cuda", "source": SSM_SOURCE, "replaces": SSM_REPLACES,
        "launches": tune_launches["ssm_scan"], "max_abs_err": ssm_rec["max_abs_err"],
        "ms": ssm_rec["ms"], "plain_ms": ssm_rec["plain_ms"],
        "bound_ms": ssm_rec["bound_ms"], "bound_by": ssm_rec["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
