"""Batched serving driver: prefill a request batch, then greedy decode.

The counterpart of the reference's ``launch/serve.py``, offline path only::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 2048 --max-new 32

The caches are allocated once at capacity prompt + max-new and written in
place by prefill and by every decode step (the reference pads its prefill
caches up to that capacity and donates them to each decode step). An untimed
warmup prefill + decode step runs first, so the timed numbers are steady
state, and the device is synchronised before every clock read. The decode
loop reports per-window p50/p99 through :class:`DecodeWindowMonitor`.

Runs on the GPU unless ``--device cpu`` is given. ``--tuned-config`` and
``--online-tune`` belong to later slices of the port and are rejected.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.archs import ARCH_NAMES

SEED = 0  # of the generator drawing default weights and prompts (the reference's PRNGKey(0))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window-steps", type=int, default=8,
                    help="decode steps per metrics window (p50/p99 reported "
                         "per window)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # accepted so that the message names the slice instead of argparse's error
    ap.add_argument("--tuned-config", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--online-tune", action="store_true", help=argparse.SUPPRESS)
    return ap


def _measured_serve(run, args, monitor, *, params=None, tokens=None):
    """One full serve of ``run``: warm up untimed, then measure prefill
    latency and per-step decode latencies into ``monitor`` (one window per
    ``args.window_steps`` decode steps).

    ``params``/``tokens`` (the port's parameter tree, a (batch, prompt-len)
    token tensor) let a caller inject weights and prompts; by default both
    are drawn from a ``torch.Generator`` seeded with :data:`SEED` on the
    device. Returns (t_prefill, t_decode, generated tokens (batch, max-new))."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.distributed.steps import make_decode_step, make_prefill_step

    device = resolve_device(args.device)
    arch = get_arch(args.arch, smoke=args.smoke)
    prefill = make_prefill_step(arch, run)
    decode = make_decode_step(arch, run)
    model = prefill.model
    if params is None or tokens is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        if params is None:
            params = model.init_params(gen, device)
        if tokens is None:
            tokens = torch.randint(0, arch.vocab_size, (args.batch, args.prompt_len),
                                   generator=gen, device=device)
    tokens = tokens.to(device)
    caches = model.cache_init(args.batch, args.prompt_len + args.max_new, device)

    def greedy(logits):
        return torch.argmax(logits, dim=-1)[:, None]

    # untimed warmup: first calls pay one-time costs (kernel build, allocator
    # growth) that must not land in the timed loop. Its decode step writes
    # position prompt-len, which the timed loop overwrites before reading.
    logits, caches = prefill(params, tokens, caches)
    decode(params, caches, greedy(logits), args.prompt_len)
    synchronize(device)

    t0 = time.perf_counter()
    logits, caches = prefill(params, tokens, caches)
    synchronize(device)
    t_prefill = time.perf_counter() - t0

    nxt = greedy(logits)
    generated = [nxt]
    in_window = 0
    t0 = time.perf_counter()
    for i in range(args.max_new - 1):
        if in_window == 0:
            monitor.begin_window()
        t_step = time.perf_counter()
        logits, caches = decode(params, caches, nxt, args.prompt_len + i)
        nxt = greedy(logits)
        synchronize(device)
        monitor.record(time.perf_counter() - t_step, tokens=args.batch)
        generated.append(nxt)
        in_window += 1
        if in_window >= args.window_steps:
            monitor.end_window()
            in_window = 0
    synchronize(device)
    t_decode = time.perf_counter() - t0
    if in_window:
        monitor.end_window()
    return t_prefill, t_decode, torch.cat(generated, dim=1)


def run_offline(args) -> int:
    from repro_torch.configs.base import RunConfig
    from repro_torch.serving.metrics import DecodeWindowMonitor

    monitor = DecodeWindowMonitor(clock=time.perf_counter)
    t_prefill, t_decode, out = _measured_serve(RunConfig(), args, monitor)

    n_new = args.max_new * args.batch
    print(f"prefill: {args.batch}×{args.prompt_len} tokens in {t_prefill:.3f}s")
    print(f"decode : {n_new} tokens in {t_decode:.3f}s "
          f"({n_new / max(t_decode, 1e-9):.1f} tok/s)")
    for w in monitor.history:
        print(f"  window {w.window}: {w.count} steps  "
              f"p50 {w.p50 * 1e3:.2f}ms  p99 {w.p99 * 1e3:.2f}ms  "
              f"{w.tokens_per_s:.1f} tok/s")
    agg = monitor.aggregate()
    if agg is not None:
        print(f"decode p50 {agg.p50 * 1e3:.2f}ms  p99 {agg.p99 * 1e3:.2f}ms "
              f"over {len(monitor.history)} windows")
    print("sampled token ids (first request):", out[0].tolist())
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.online_tune:
        raise SystemExit("--online-tune is not ported yet: it comes with the "
                         "online-tuner slice of repro_torch (see ROADMAP.md)")
    if args.tuned_config:
        raise SystemExit("--tuned-config is not ported yet: it comes with the "
                         "search-space slice of repro_torch (see ROADMAP.md)")
    return run_offline(args)


if __name__ == "__main__":
    raise SystemExit(main())
