"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``_kernel``, ``flash_attention_fwd``). The kernel is ``csrc/flash_fwd.cu``,
written by hand for ``sm_90a``; its header says what bounds it on the H100
(the tensor-core rate at the serve shape; in practice, in this first f32
CUDA-core design, shared-memory load issue) and what its design does about
it.

``flash_attention_fwd`` routes on where its tensors lie and nowhere else:

  - CUDA tensors → the kernel, or an exception (unsupported dtype, head dim
    or tile, non-contiguous input, a refused launch). There is no fallback.
  - CPU tensors → :func:`flash_attention_plain`, a plain torch version of
    the same function: the same padding, the same tile loop bounds and the
    same per-tile online softmax as the kernel (and as the TPU kernel's
    ``_kernel`` body). The CPU tests hold it against the JAX reference; the
    chip smoke holds the kernel against it on the card.

``LAUNCHES`` counts kernel launches (never plain-version calls), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
TILES = (32, 64)  # block_q and block_kv values the kernel is compiled for
DEFAULT_BLOCK = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0


def _bounds(q_start: int, block_q: int, t: int, t_valid: int, *, causal: bool,
            window: int, block_kv: int) -> range:
    """KV tile indices a query tile visits: the tiles that are fully masked
    for every row of the tile (future under causal, older than the window,
    past kv_length) are outside the range, as in the kernel's loop."""
    kv_hi = min(t, t_valid)
    if causal:
        kv_hi = min(kv_hi, q_start + block_q)
    kv_lo = max(0, q_start - window + 1) if window > 0 else 0
    return range(kv_lo // block_kv, -(-kv_hi // block_kv))


def flash_attention_plain(
    q: torch.Tensor,  # (B, S, Hq, Dh)
    k: torch.Tensor,  # (B, T, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_length: Optional[int] = None,
    block_q: int = DEFAULT_BLOCK,
    block_kv: int = DEFAULT_BLOCK,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in torch ops, tile by tile: f32 math, online
    softmax with the finite NEG_INF, GQA by grouping query heads over their
    KV head (no repeated K/V), output in ``q.dtype``."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh**-0.5 if scale is None else scale
    t_valid = t if kv_length is None else int(kv_length)
    pad_q, pad_kv = (-s) % block_q, (-t) % block_kv
    qf = F.pad(q.float() * scale, (0, 0, 0, 0, 0, pad_q))
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad_kv))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad_kv))
    qf = qf.view(b, s + pad_q, hkv, g, dh)
    out = torch.empty((b, s + pad_q, hkv, g, dh), dtype=torch.float32, device=q.device)
    for q_start in range(0, s + pad_q, block_q):
        qt = qf[:, q_start:q_start + block_q]  # (B, bq, Hkv, G, Dh)
        q_pos = torch.arange(q_start, q_start + block_q, device=q.device)[:, None]
        m_run = torch.full((b, hkv, g, block_q), NEG_INF, device=q.device)
        l_run = torch.zeros((b, hkv, g, block_q), device=q.device)
        acc = torch.zeros((b, hkv, g, block_q, dh), device=q.device)
        for tile in _bounds(q_start, block_q, t, t_valid, causal=causal,
                            window=window, block_kv=block_kv):
            k_start = tile * block_kv
            kt = kf[:, k_start:k_start + block_kv]  # (B, bkv, Hkv, Dh)
            vt = vf[:, k_start:k_start + block_kv]
            sc = torch.einsum("bnhgd,bmhd->bhgnm", qt, kt)
            if softcap:
                sc = softcap * torch.tanh(sc / softcap)
            k_pos = torch.arange(k_start, k_start + block_kv, device=q.device)[None, :]
            mask = k_pos < t_valid
            if causal:
                mask = mask & (k_pos <= q_pos)
            if window > 0:
                mask = mask & (q_pos - k_pos < window)
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            corr = torch.exp(m_run - m_new)
            p = torch.exp(sc - m_new[..., None])
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgnm,bmhd->bhgnd", p, vt)
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, q_start:q_start + block_q] = o.permute(0, 3, 1, 2, 4)
    return out[:, :s].reshape(b, s, hq, dh).to(q.dtype)


def _check(q, k, v, block_q, block_kv, kv_length) -> int:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,S,Hq,Dh), k = v (B,T,Hkv,Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"kernel head dims are {HEAD_DIMS}, got {dh}")
    if block_q not in TILES or block_kv not in TILES:
        raise ValueError(f"kernel tiles are {TILES}, got block_q={block_q} "
                         f"block_kv={block_kv} (snap them with ops.snap_block)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous (B,S,H,Dh) tensors")
    t_valid = t if kv_length is None else int(kv_length)
    if not 0 <= t_valid <= t:
        raise ValueError(f"kv_length {kv_length} outside [0, {t}]")
    return t_valid


def _flash_fwd_fn():
    from repro_torch.kernels import _build

    fn = _build.library("flash_fwd").flash_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                       i32, i32, i32, i32, ctypes.c_float, ctypes.c_float, i32,
                       ptr]
        fn.restype = i32
    return fn


def flash_attention_fwd(
    q: torch.Tensor,  # (B, S, Hq, Dh)
    k: torch.Tensor,  # (B, T, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_length: Optional[int] = None,
    block_q: int = DEFAULT_BLOCK,
    block_kv: int = DEFAULT_BLOCK,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention forward. ``scale`` defaults to dh^-0.5 (pass 1.0 for
    pre-scaled q). Window and kv_length are static ints. A CUDA tensor goes
    to the kernel, a CPU tensor to :func:`flash_attention_plain`."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            kv_length=kv_length, block_q=block_q, block_kv=block_kv, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    t_valid = _check(q, k, v, block_q, block_kv, kv_length)
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = dh**-0.5 if scale is None else scale
    fn = _flash_fwd_fn()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, s, t, hq, hkv, dh, block_q, block_kv,
                 int(bool(causal)), int(window), float(softcap), float(scale),
                 t_valid, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError_t {err} "
                           f"(q {tuple(q.shape)}, tiles {block_q}x{block_kv})")
    LAUNCHES += 1
    return out
