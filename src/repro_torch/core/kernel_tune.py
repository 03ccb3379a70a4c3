"""Kernel autotuning as a Study workload, on the H100.

The port of ``repro/core/kernel_tune.py``: each hand-written CUDA kernel's
knobs form a :class:`~repro_torch.core.space.TunableSpace`, and a
:class:`KernelEvaluator` benchmarks one kernel *variant* per trial:

  - **numerics gate**: every variant's output is held against the ``ref.py``
    oracle *before* it is timed. The gate applies the reference's relative
    test (``max|out - ref| / max|ref|`` within ``_DEFAULT_TOL``) and, beside
    it, an element-wise bound ``|out - ref| <= rtol*|ref| + atol`` (see
    :func:`elementwise_bound`). A variant that fails either is a
    ``numerics_mismatch`` trial with the infeasible penalty, so a
    fast-but-wrong tile or chunk configuration never becomes the incumbent.
  - **fidelity** via scaled repeats (``max(1, round(repeats × f))``).
  - **isolation**: ``parallel_safe = False``: in-process trials share the
    card and must not overlap their timings.

Cells are keyed ``kernel-cuda/<kernel>.<dtype>:<shape-class>``, a namespace
of their own: H100 measurements never replay as the reference's TPU cells
(``kernel/...``), or the reverse. :func:`kernel_similarity` makes shape
classes of the *same* kernel+dtype finite-distance siblings, so transfer
priors carry block-size evidence between input scales. Incumbents persist
to the port's own tuned table (:func:`write_tuned_entries`), which the
kernels' ``ops.py`` read when the caller passes no knobs.

``rwkv6`` keeps its name, shapes and shape class here, but its kernel comes
in a later slice: its evaluator raises.
"""
from __future__ import annotations

import contextlib
import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.space import IntParam, TunableSpace
from repro_torch.core.transfer import CellKey
from repro_torch.kernels import (
    _TABLE_VERSION,
    DEFAULT_TABLE_PATH,
    dtype_token,
    flash_shape_class,
    invalidate_tuned_table_cache,
    rwkv6_shape_class,
    shape_class_distance,
    ssm_shape_class,
    table_key,
)

__all__ = [
    "KERNEL_NAMES",
    "KERNEL_SPACES",
    "DEFAULT_SHAPES",
    "KernelEvaluator",
    "elementwise_bound",
    "kernel_platform_key",
    "kernel_similarity",
    "make_kernel_evaluator",
    "parse_kernel_platform",
    "shape_class_for",
    "tuned_entry",
    "write_tuned_entries",
]

KERNEL_NAMES = ("flash_attention", "rwkv6", "ssm_scan")
NAMESPACE = "kernel-cuda"

# One TunableSpace per ported kernel. Every point is a legal launch of the
# CUDA kernel at every head dim / state size it is compiled for, within the
# 232,448 B of shared memory a block may opt into (the CPU tests check it).
KERNEL_SPACES: Dict[str, TunableSpace] = {
    # the compiled tiles: the reference's 128..1024 would all snap to 64
    "flash_attention": TunableSpace(
        platform="kernel.flash_attention",
        params=(
            IntParam("block_q", 64, lo=32, hi=64, pow2=True),
            IntParam("block_kv", 64, lo=32, hi=64, pow2=True),
        ),
        most_influential=("block_q", "block_kv"),
    ),
    # the reference's space: d_block is threads per block (at most 1024),
    # chunk the timesteps of B and C staged in shared memory
    "ssm_scan": TunableSpace(
        platform="kernel.ssm_scan",
        params=(
            IntParam("chunk", 128, lo=16, hi=256, pow2=True),
            IntParam("d_block", 256, lo=16, hi=1024, pow2=True),
        ),
        most_influential=("chunk", "d_block"),
    ),
}

# Shape tuples per kernel (the CLI default sweep), the reference's:
#   flash_attention: (B, S, Hq, Hkv, Dh)
#   rwkv6:           (B, S, H, Hd)
#   ssm_scan:        (B, S, Di, N)
DEFAULT_SHAPES: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "flash_attention": ((2, 256, 4, 2, 64), (1, 512, 4, 2, 64)),
    "rwkv6": ((2, 160, 3, 32), (1, 256, 2, 64)),
    "ssm_scan": ((2, 128, 64, 8), (1, 256, 64, 16)),
}

_SHAPE_RANK = {"flash_attention": 5, "rwkv6": 4, "ssm_scan": 4}

# the reference's relative-error gates per dtype
_DEFAULT_TOL = {"f32": 1e-4, "bf16": 3e-2, "f16": 3e-2}

# one rounding step of the output dtype, relative: two f32 values within
# atol of each other round to outputs at most this far apart (times |ref|)
_RTOL = {"f32": 2.0**-23, "bf16": 2.0**-7}

_U32 = 2.0**-24  # unit roundoff of f32, the oracle's and the kernels' math

_TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def shape_class_for(kernel: str, shape: Tuple[int, ...]) -> str:
    """The compact dims string a shape tuple belongs to (see
    ``repro_torch.kernels``)."""
    if kernel == "flash_attention":
        b, s, hq, hkv, dh = shape
        return flash_shape_class((b, s, hq, dh), (b, s, hkv, dh))
    if kernel == "rwkv6":
        return rwkv6_shape_class(shape)
    if kernel == "ssm_scan":
        b, s, di, n = shape
        return ssm_shape_class((b, s, di), n)
    raise ValueError(f"unknown kernel {kernel!r} (one of {KERNEL_NAMES})")


def kernel_platform_key(kernel: str, dtype: Any, shape_class: str) -> str:
    """Cache namespace for one kernel cell:
    ``kernel-cuda/<kernel>.<dtype>:<shape-class>``."""
    return f"{NAMESPACE}/{kernel}.{dtype_token(dtype)}:{shape_class}"


def parse_kernel_platform(platform: str) -> Tuple[str, str, str]:
    """Inverse of :func:`kernel_platform_key` → (kernel, dtype, shape_class)."""
    base, _, cell = platform.partition("/")
    if base != NAMESPACE or ":" not in cell:
        raise ValueError(f"not a {NAMESPACE} cell namespace: {platform!r}")
    arch, _, shape_class = cell.partition(":")
    kernel, _, dtype = arch.rpartition(".")
    if kernel not in KERNEL_NAMES:
        raise ValueError(f"unknown kernel in namespace {platform!r}")
    return kernel, dtype, shape_class


def kernel_similarity(a: CellKey, b: CellKey) -> float:
    """Sibling distance for kernel cells: ``inf`` across different kernels
    or dtypes (their knob sets / numerics aren't comparable evidence),
    summed |log2| dim distance between shape classes otherwise — a 256-token
    sweep informs the 512-token cell at weight exp(-1)."""
    if a.base != b.base or a.arch != b.arch:
        return math.inf
    if a.shape is None or b.shape is None:
        return 0.5 if a.shape == b.shape else math.inf
    return shape_class_distance(a.shape, b.shape)


def elementwise_bound(kernel: str, dtype: str, data: Tuple[torch.Tensor, ...],
                      oracle: Any) -> Tuple[torch.Tensor, float]:
    """Per-element bound on ``|out - ref|`` for a correct variant:
    ``rtol*|ref| + atol`` with ``rtol`` one rounding step of the output dtype
    and ``atol = 2·γ(n)·mag``, twice the oracle's own f32 error bound.

    Derivation (first order, Higham's γ(n) = n·u / (1 - n·u), u = 2^-24):
    a sum or product of f32 values computed with n roundings on its longest
    path is within γ(n) of the exact value, relative to the same expression
    over the absolute values of its terms, ``mag``. Kernel and oracle are
    both such computations of one function, in different orders, so they
    differ by at most twice that, and ``rtol`` covers their output rounding.

      - ssm_scan: y_t = Σ_n h_t[n]·c_t[n] with h_t = Σ_{s<=t} (Π e^{Δ·a})
        (Δ_s·u_s)·b_s. Each of the S steps a term lives through rounds the
        exponent's product, exp itself (within 2 ulp = 4u) and the step's
        product and sum: 8 per step, counted generously; Δ·u, the product
        with b and the N-term sum with c add N + 3. Since Δ >= 0 and
        e^{Δ·a} > 0, ``mag`` = the oracle on (Δ, |u|, |b|, |c|, a) bounds
        Σ_n |h_t[n]|·|c_t[n]| element-wise: cancellation in y does not
        loosen the bound where y is small, as a fixed atol would.
      - flash_attention: o = Σ_j p_j·v_j / Σ_j p_j with p_j = e^{s_j - m}.
        A score is a Dh-term dot product, so its absolute error is at most
        Dh·u·σ with σ = max‖q_i‖₂·max‖k_j‖₂ (Cauchy–Schwarz over |q|, |k|);
        e^{·} turns it into a relative error of p. The sums over T keys in
        numerator and denominator add 2T, exp, the max subtraction and the
        per-tile rescaling a few more: n = 2T + Dh·σ + 8, and ``mag`` = the
        oracle on (q, k, |v|).

    Returns ``(atol, rtol)``: the f32 tensor ``2·γ(n)·mag`` and the float.
    """
    if kernel == "ssm_scan":
        dt_in, u, bt, ct, a = (x.float() for x in data)
        s, n_state = dt_in.shape[1], a.shape[1]
        mag = oracle(dt_in, u.abs(), bt.abs(), ct.abs(), a)
        n = 8 * s + n_state + 3
    elif kernel == "flash_attention":
        q, k, v = (x.float() for x in data)
        t, dh = k.shape[1], k.shape[3]
        sigma = float(q.norm(dim=-1).max() * k.norm(dim=-1).max())
        mag = oracle(q, k, v.abs(), causal=True, scale=1.0)
        n = 2 * t + dh * sigma + 8
    else:
        raise ValueError(f"no element-wise bound for kernel {kernel!r}")
    gamma = n * _U32 / (1.0 - n * _U32)
    return 2.0 * gamma * mag, _RTOL[dtype]


@contextlib.contextmanager
def _full_f32_matmul():
    """The oracle's einsums in full f32, whatever the caller enabled."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------- evaluator


@dataclass
class KernelEvaluator:
    """Benchmark one CUDA-kernel variant per trial.

    ``__call__(config)`` calls the kernel's public entry point with the
    trial's knobs, runs it once untimed (the first call also builds the
    kernels with nvcc), holds its output against the ``ref.py`` oracle
    (mismatch ⇒ infeasible penalty before any timing), then times
    ``repeats`` runs and returns the best. On the card the timer is a pair
    of CUDA events on the launch stream; on the CPU (``device="cpu"``, where
    the entry points run the kernels' plain versions) ``perf_counter``.
    ``info["timer"]`` names it.

    Inputs, the oracle output and the element-wise bound are made once per
    evaluator from a seeded ``torch.Generator`` (on the CPU, then moved, so
    the card and the CPU see the same numbers) and reused across trials, so
    every variant is measured on identical data.
    """

    kernel: str
    shape: Tuple[int, ...]
    dtype: str = "f32"
    repeats: int = 5
    device: Any = "cuda"
    tolerance: Optional[float] = None
    seed: int = 0
    spec: Optional[Any] = None  # EvaluatorSpec for subprocess workers
    # one card per process: in-process trials must not overlap their timings
    parallel_safe = False
    supports_fidelity = True  # scaled repeats

    INFEASIBLE = float("inf")

    def __post_init__(self):
        from repro_torch.device import resolve_device

        if self.kernel not in KERNEL_NAMES:
            raise ValueError(
                f"unknown kernel {self.kernel!r} (one of {KERNEL_NAMES})"
            )
        if self.kernel not in KERNEL_SPACES:
            raise NotImplementedError(
                f"the {self.kernel} kernel is not ported yet: slice 3 of the "
                "port brings wkv6_chunked with its kernel-tune cell (ROADMAP)"
            )
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(
                f"the CUDA kernels take {sorted(_TORCH_DTYPES)}, got "
                f"dtype={self.dtype!r}"
            )
        self.shape = tuple(int(d) for d in self.shape)
        want = _SHAPE_RANK[self.kernel]
        if len(self.shape) != want:
            raise ValueError(
                f"{self.kernel} shapes have {want} dims "
                f"({'B,S,Hq,Hkv,Dh' if want == 5 else 'see DEFAULT_SHAPES'}), "
                f"got {self.shape}"
            )
        if self.tolerance is None:
            self.tolerance = _DEFAULT_TOL.get(self.dtype, 1e-4)
        self.device = resolve_device(self.device)
        # inputs + oracle output + element-wise bound
        self._data: Optional[Tuple[Any, ...]] = None

    def __getstate__(self):
        # device tensors must never cross a process boundary; workers rebuild
        state = self.__dict__.copy()
        state["_data"] = None
        return state

    # -- identity helpers

    def shape_class(self) -> str:
        return shape_class_for(self.kernel, self.shape)

    def platform_key(self) -> str:
        return kernel_platform_key(self.kernel, self.dtype, self.shape_class())

    def clear_caches(self) -> None:
        """Between-trial hook of the engine (``EngineConfig.clear_caches``):
        return the caching allocator's free blocks to the card. Inputs and
        the oracle stay, so every variant still sees the same data."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- data / variant construction

    def _materialize(self) -> Tuple[Any, ...]:
        """(inputs..., oracle output, (atol, rtol)): made once, reused."""
        if self._data is not None:
            return self._data
        gen = torch.Generator().manual_seed(self.seed)
        dt = _TORCH_DTYPES[self.dtype]

        def normal(*shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32)

        def put(x):
            return x.to(dt).to(self.device).contiguous()

        if self.kernel == "flash_attention":
            from repro_torch.kernels.flash_attention.ref import attention_ref as oracle

            b, s, hq, hkv, dh = self.shape
            # q pre-scaled, scale=1.0 everywhere (the model's convention)
            inputs = (put(normal(b, s, hq, dh) * dh**-0.5),
                      put(normal(b, s, hkv, dh)), put(normal(b, s, hkv, dh)))
            with _full_f32_matmul():
                ref = oracle(*inputs, causal=True, scale=1.0)
                bound = elementwise_bound(self.kernel, self.dtype, inputs, oracle)
        else:  # ssm_scan
            from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref as oracle

            b, s, di, n = self.shape
            inputs = (put(torch.nn.functional.softplus(normal(b, s, di))),
                      put(normal(b, s, di)), put(normal(b, s, n)),
                      put(normal(b, s, n)), put(-torch.exp(0.3 * normal(di, n))))
            with _full_f32_matmul():
                ref = oracle(*inputs)
                bound = elementwise_bound(self.kernel, self.dtype, inputs, oracle)
        self._data = (*inputs, ref, bound)
        return self._data

    def _variant(self, config: Dict[str, Any]):
        """(zero-arg job, oracle output, (atol, rtol)) for one knob config."""
        data = self._materialize()
        if self.kernel == "flash_attention":
            from repro_torch.kernels.flash_attention.ops import flash_attention

            q, k, v, ref, bound = data
            bq, bkv = int(config["block_q"]), int(config["block_kv"])
            return (lambda: flash_attention(q, k, v, causal=True, scale=1.0,
                                            block_q=bq, block_kv=bkv)), ref, bound
        from repro_torch.kernels.ssm_scan.ops import selective_scan

        dt_in, u, bt, ct, a, ref, bound = data
        chunk, d_block = int(config["chunk"]), int(config["d_block"])
        return (lambda: selective_scan(dt_in, u, bt, ct, a, chunk=chunk,
                                       d_block=d_block)), ref, bound

    def _timed(self, job) -> float:
        """Seconds of one run of ``job``."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            job()
            return time.perf_counter() - t0
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        job()
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    # -- the evaluator protocol

    def __call__(
        self, config: Dict[str, Any], fidelity: float = 1.0
    ) -> Tuple[float, Dict[str, Any]]:
        from repro_torch.device import synchronize

        with contextlib.ExitStack() as ctx:
            if self.device.type == "cuda":
                # the scheduler calls from a worker thread: launch and time on
                # the tensors' own device and its current stream
                ctx.enter_context(torch.cuda.device(self.device))
            job, ref, (atol, rtol) = self._variant(config)
            out = job()  # untimed: the first call builds the kernels
            synchronize(self.device)

            # numerics gate BEFORE timing: a wrong variant must never be ranked
            out32, ref32 = out.float(), ref.float()
            diff = (out32 - ref32).abs()
            rel = float(diff.max() / (ref32.abs().max() + 1e-9))
            allowed = rtol * ref32.abs() + atol
            excess = float((diff / allowed).max())
            info: Dict[str, Any] = {
                "kernel": self.kernel,
                "shape_class": self.shape_class(),
                "max_rel_err": rel,
                "tol_excess": excess,
                "device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
            }
            if (not math.isfinite(rel) or rel > self.tolerance
                    or not bool((diff <= allowed).all())):
                info["numerics_mismatch"] = True
                info["tolerance"] = self.tolerance
                return self.INFEASIBLE, info

            repeats = self.repeats
            if fidelity < 1.0:
                repeats = max(1, int(round(self.repeats * fidelity)))
                info["fidelity"] = fidelity
            times = [self._timed(job) for _ in range(repeats)]
        info["repeats"] = repeats
        info["timer"] = "cuda_events" if self.device.type == "cuda" else "perf_counter"
        info["spread_s"] = max(times) - min(times)
        return min(times), info


def make_kernel_evaluator(
    kernel: str,
    shape: Tuple[int, ...],
    dtype: str = "f32",
    *,
    repeats: int = 5,
    device: Any = "cuda",
    tolerance: Optional[float] = None,
    seed: int = 0,
) -> KernelEvaluator:
    """Module-level factory (the dotted-path target subprocess workers
    resolve), with the matching :class:`EvaluatorSpec` pre-attached."""
    from repro_torch.core.executors import EvaluatorSpec

    ev = KernelEvaluator(
        kernel, tuple(int(d) for d in shape), dtype,
        repeats=repeats, device=device, tolerance=tolerance, seed=seed,
    )
    ev.spec = EvaluatorSpec.factory(
        "repro_torch.core.kernel_tune:make_kernel_evaluator",
        kernel, tuple(int(d) for d in shape), dtype,
        repeats=repeats, device=str(ev.device), tolerance=tolerance, seed=seed,
    )
    return ev


# -------------------------------------------------------------- tuned table


def write_tuned_entries(
    entries: Dict[str, Dict[str, Any]],
    path: Optional[Path] = None,
) -> Path:
    """Merge ``{table_key: {"config": .., "time_s": .., "source": ..}}``
    into the port's tuned table (creating it if absent) and invalidate the
    loader cache so the very next kernel call sees the new incumbents."""
    p = Path(path) if path is not None else DEFAULT_TABLE_PATH
    existing: Dict[str, Any] = {}
    if p.exists():
        try:
            raw = json.loads(p.read_text())
            if isinstance(raw, dict) and isinstance(raw.get("entries"), dict):
                existing = raw["entries"]
        except (ValueError, OSError):
            existing = {}  # a corrupt table is replaced wholesale
    existing.update(entries)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        {"version": _TABLE_VERSION, "entries": dict(sorted(existing.items()))},
        indent=1,
    ) + "\n")
    invalidate_tuned_table_cache()
    return p


def tuned_entry(
    kernel: str, dtype: str, shape_class: str,
    config: Dict[str, Any], time_s: float, source: str,
) -> Dict[str, Dict[str, Any]]:
    """One table entry, keyed for :func:`write_tuned_entries`."""
    space = KERNEL_SPACES[kernel]
    known = set(space.names())
    return {
        table_key(kernel, dtype, shape_class): {
            "config": {k: v for k, v in config.items() if k in known},
            "time_s": float(time_s),
            "source": source,
        }
    }
