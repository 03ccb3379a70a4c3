"""Selective scan: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssm_scan/kernel.py``
(``_kernel``, ``ssm_scan``). The kernel is ``csrc/ssm_scan.cu``, written by
hand for ``sm_90a``. What bounds it on the H100: at the full-width
Jamba-1.5-Large cell (B1·S4096·di16384·N16, bf16) the bytes (403 MB, each
input read once and y written once: 0.120 ms at 3.35 TB/s); its 1.07e9
exponentials need ~0.26 ms of the special-function units on their own. Its
design (one thread per channel with the N-wide f32 state in registers, B and
C staged per chunk in shared memory) is in the source's header.

``ssm_scan`` routes on where its tensors lie and nowhere else:

  - CUDA tensors → the kernel, or an exception (unsupported dtype or state
    size N, a knob the kernel does not take, non-contiguous or mismatched
    inputs, a refused launch). There is no fallback.
  - CPU tensors → :func:`ssm_scan_plain`, a plain torch version of the same
    function with the kernel's arithmetic: every product and sum rounded
    once, in the kernel's order. The CPU tests hold it against the JAX
    reference; the chip smoke holds the kernel against it on the card.

``LAUNCHES`` counts kernel launches (never plain-version calls), so a run can
show that its path went through the kernel; ``LAST_LAUNCH`` holds the knobs
of the latest launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

STATE_DIMS = (4, 8, 16, 32, 64)  # the N values the kernel is compiled for
MAX_D_BLOCK = 1024  # threads per block
# per-block opt-in shared memory of an H100 (227 KB)
SMEM_LIMIT = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
LAST_LAUNCH: Optional[Dict[str, int]] = None


def smem_footprint(chunk: int, n: int) -> int:
    """Shared-memory bytes one block of ``csrc/ssm_scan.cu`` allocates:
    ``chunk`` timesteps of b_t and c_t, staged as f32 whatever the input
    dtype. dt, u and y are not staged (each thread reads and writes its own
    channel) and the state lives in registers, so d_block does not change
    it. Monotone in ``chunk``."""
    return 2 * int(chunk) * int(n) * 4


def ssm_scan_plain(dt, u, b_t, c_t, a):
    """The kernel's function in torch ops: f32 state, each product and sum
    rounded once (no fused multiply-add), y summed over n in order; the
    output in ``dt.dtype``. It runs on any device; the wrapper takes it only
    for CPU tensors."""
    dtf, uf = dt.float(), u.float()
    bf, cf, af = b_t.float(), c_t.float(), a.float()
    b, s, di = dt.shape
    n = af.shape[1]
    h = torch.zeros((b, di, n), dtype=torch.float32, device=dt.device)
    y = torch.empty((b, s, di), dtype=torch.float32, device=dt.device)
    for t in range(s):
        dt_t = dtf[:, t, :, None]  # (B, di, 1)
        du = dt_t * uf[:, t, :, None]
        h = torch.exp(dt_t * af) * h + du * bf[:, t, None, :]
        c = cf[:, t]  # (B, N)
        acc = h[:, :, 0] * c[:, None, 0]
        for k in range(1, n):
            acc = acc + h[:, :, k] * c[:, None, k]
        y[:, t] = acc
    return y.to(dt.dtype)


def _check(dt, u, b_t, c_t, a, chunk: int, d_block: int) -> None:
    """Raise on anything the kernel does not take."""
    if (dt.dim() != 3 or u.shape != dt.shape or b_t.dim() != 3
            or c_t.shape != b_t.shape or a.dim() != 2):
        raise ValueError(f"need dt = u (B,S,di), b_t = c_t (B,S,N), a (di,N); got "
                         f"{tuple(dt.shape)}, {tuple(u.shape)}, {tuple(b_t.shape)}, "
                         f"{tuple(c_t.shape)}, {tuple(a.shape)}")
    b, s, di = dt.shape
    n = a.shape[1]
    if b_t.shape[:2] != (b, s) or b_t.shape[2] != n or a.shape[0] != di:
        raise ValueError(f"dt {tuple(dt.shape)}, b_t {tuple(b_t.shape)} and a "
                         f"{tuple(a.shape)} disagree")
    if min(b, s, di) < 1 or b > 65535:
        raise ValueError(f"kernel takes 1 <= B <= 65535 and non-empty S, di; got "
                         f"{tuple(dt.shape)}")
    tensors = (dt, u, b_t, c_t, a)
    if len({x.dtype for x in tensors}) != 1 or dt.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16 inputs of one dtype, "
                         f"got {[x.dtype for x in tensors]}")
    if n not in STATE_DIMS:
        raise ValueError(f"kernel state sizes N are {STATE_DIMS}, got {n}")
    if not 1 <= d_block <= MAX_D_BLOCK:
        raise ValueError(f"d_block {d_block} outside [1, {MAX_D_BLOCK}] "
                         f"(threads per block)")
    if chunk < 1 or smem_footprint(chunk, n) > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} at N={n} needs {smem_footprint(chunk, n)} B "
                         f"of shared memory, the limit is {SMEM_LIMIT}")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("the inputs lie on different devices")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("kernel takes contiguous inputs")


def _ssm_scan_fn():
    from repro_torch.kernels import _build

    fn = _build.library("ssm_scan").ssm_scan
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                       i32, i32, ptr]
        fn.restype = i32
    return fn


def ssm_scan(dt, u, b_t, c_t, a, *, chunk: int = 128, d_block: int = 256):
    """dt/u: (B, S, di); b_t/c_t: (B, S, N); a: (di, N). Returns y (B, S, di)
    in ``dt.dtype`` (the h·C contraction; the caller adds the D-skip and the
    gating). A CUDA tensor goes to the kernel, a CPU tensor to
    :func:`ssm_scan_plain`."""
    global LAUNCHES, LAST_LAUNCH
    if dt.device.type == "cpu":
        return ssm_scan_plain(dt, u, b_t, c_t, a)
    if dt.device.type != "cuda":
        raise ValueError(f"no selective-scan path for device {dt.device}")
    chunk, d_block = int(chunk), int(d_block)
    _check(dt, u, b_t, c_t, a, chunk, d_block)
    b, s, di = dt.shape
    n = a.shape[1]
    fn = _ssm_scan_fn()
    y = torch.empty_like(dt)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = fn(dt.data_ptr(), u.data_ptr(), b_t.data_ptr(), c_t.data_ptr(),
                 a.data_ptr(), y.data_ptr(), _DTYPE_CODE[dt.dtype], b, s, di, n,
                 chunk, d_block, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed with cudaError_t {err} "
                           f"(dt {tuple(dt.shape)}, N {n}, chunk {chunk}, "
                           f"d_block {d_block})")
    LAUNCHES += 1
    LAST_LAUNCH = {"chunk": chunk, "d_block": d_block}
    return y
