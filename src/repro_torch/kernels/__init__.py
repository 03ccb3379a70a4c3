"""Hand-written CUDA kernels for Hopper + the port's tuned-config table.

Kernel subpackages (``flash_attention``, ``ssm_scan``) each ship ``csrc/``
(the CUDA C++ source, built at first launch by :mod:`._build`), ``kernel.py``
(the wrapper that launches it, beside a plain PyTorch version of the same
function), ``ops.py`` (the public entry point with the routing rules) and
``ref.py`` (an O(S·T) oracle).

This package root holds the **tuned-config table** lookup, a copy of the
reference's (``repro/kernels/__init__.py``) keyed by
``(kernel, dtype, shape-class)``. It reads the port's **own** table,
``src/repro_torch/kernels/tuned_table.json`` (not shipped: a missing table
means defaults), or the file named by ``REPRO_TORCH_KERNEL_TUNED_TABLE``.
Entries measured on the H100 never replay as TPU entries, or the reverse:
the reference reads another file under another variable.

Everything here is stdlib-only: importing ``repro_torch.kernels`` needs no
CUDA, no ``nvcc`` and no torch.
"""
from __future__ import annotations

import json
import math
import os
import re
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "DEFAULT_TABLE_PATH",
    "TUNED_TABLE_ENV",
    "dtype_token",
    "flash_shape_class",
    "invalidate_tuned_table_cache",
    "load_tuned_table",
    "parse_shape_class",
    "rwkv6_shape_class",
    "shape_class_distance",
    "ssm_shape_class",
    "table_key",
    "tuned_config",
]

TUNED_TABLE_ENV = "REPRO_TORCH_KERNEL_TUNED_TABLE"
DEFAULT_TABLE_PATH = Path(__file__).with_name("tuned_table.json")

_TABLE_VERSION = 1  # the "version" field write_tuned_entries stamps

# one cache slot per resolved path: kernel call sites hit a dict lookup, not
# the filesystem (write_tuned_entries clears it after writing a table)
_table_cache: Dict[Path, Dict[str, Dict[str, Any]]] = {}


def dtype_token(dtype: Any) -> str:
    """Canonical short dtype name (``f32``/``bf16``/``f16``/...) from a torch
    or numpy dtype, or a string."""
    name = getattr(dtype, "name", None) or str(dtype)
    name = name.rsplit(".", 1)[-1]  # e.g. "torch.float32"
    return {
        "float32": "f32",
        "float16": "f16",
        "bfloat16": "bf16",
        "float64": "f64",
        "int8": "i8",
    }.get(name, name)


def flash_shape_class(q_shape: Tuple[int, ...], k_shape: Tuple[int, ...]) -> str:
    """(B,S,Hq,Dh) × (B,T,Hkv,Dh) → ``b{B}s{S}h{Hq}k{Hkv}d{Dh}``."""
    b, s, hq, dh = q_shape
    hkv = k_shape[2]
    return f"b{b}s{s}h{hq}k{hkv}d{dh}"


def rwkv6_shape_class(r_shape: Tuple[int, ...]) -> str:
    """(B,S,H,Hd) → ``b{B}s{S}h{H}d{Hd}``."""
    b, s, h, hd = r_shape
    return f"b{b}s{s}h{h}d{hd}"


def ssm_shape_class(dt_shape: Tuple[int, ...], n: int) -> str:
    """(B,S,Di) + state size N → ``b{B}s{S}di{Di}n{N}``."""
    b, s, di = dt_shape
    return f"b{b}s{s}di{di}n{n}"


_DIM_RE = re.compile(r"([a-z]+)(\d+)")


def parse_shape_class(cls: str) -> Dict[str, int]:
    """``"b2s256h4k2d64"`` → ``{"b": 2, "s": 256, "h": 4, "k": 2, "d": 64}``."""
    return {m.group(1): int(m.group(2)) for m in _DIM_RE.finditer(cls)}


def shape_class_distance(a: str, b: str) -> float:
    """Summed |log2| ratio over the dims two classes share; ``inf`` when the
    dim alphabets differ (different kernel families never match)."""
    da, db = parse_shape_class(a), parse_shape_class(b)
    if set(da) != set(db) or not da:
        return float("inf")
    return sum(abs(math.log2(max(da[k], 1) / max(db[k], 1))) for k in da)


def table_key(kernel: str, dtype: Any, shape_class: str) -> str:
    return f"{kernel}|{dtype_token(dtype)}|{shape_class}"


def _table_path(path: Optional[Path] = None) -> Path:
    if path is not None:
        return Path(path)
    env = os.environ.get(TUNED_TABLE_ENV)
    return Path(env) if env else DEFAULT_TABLE_PATH


def load_tuned_table(path: Optional[Path] = None) -> Dict[str, Dict[str, Any]]:
    """The tuned-config entries, ``{table_key: {"config": {...}, ...}}``.

    Missing file → empty table (kernels keep their defaults). Corrupt file or
    wrong schema → one warning, then the same clean fallback: a bad table
    must never break a forward pass."""
    p = _table_path(path)
    if p in _table_cache:
        return _table_cache[p]
    entries: Dict[str, Dict[str, Any]] = {}
    if p.exists():
        try:
            raw = json.loads(p.read_text())
            if not isinstance(raw, dict) or not isinstance(raw.get("entries"), dict):
                raise ValueError("expected {'version': .., 'entries': {..}}")
            for key, rec in raw["entries"].items():
                if not isinstance(rec, dict) or not isinstance(rec.get("config"), dict):
                    raise ValueError(f"entry {key!r} has no config dict")
                entries[str(key)] = rec
        except (ValueError, OSError, UnicodeDecodeError) as e:
            warnings.warn(
                f"ignoring corrupt kernel tuned table {p}: {e} "
                "(kernels fall back to their defaults)",
                RuntimeWarning,
                stacklevel=2,
            )
            entries = {}
    _table_cache[p] = entries
    return entries


def invalidate_tuned_table_cache() -> None:
    """Drop every cached table (call after writing a new one)."""
    _table_cache.clear()


def tuned_config(
    kernel: str, dtype: Any, shape_class: str, path: Optional[Path] = None
) -> Optional[Dict[str, Any]]:
    """Best tuned knob dict for ``(kernel, dtype, shape_class)`` or None.

    An exact shape-class hit wins; otherwise the nearest tuned class of the
    same kernel + dtype (finite :func:`shape_class_distance`) donates its
    config, and the ops layer's snap re-legalises it for the actual shape."""
    table = load_tuned_table(path)
    if not table:
        return None
    exact = table.get(table_key(kernel, dtype, shape_class))
    if exact is not None:
        return dict(exact["config"])
    prefix = f"{kernel}|{dtype_token(dtype)}|"
    best, best_d = None, float("inf")
    for key, rec in table.items():
        if not key.startswith(prefix):
            continue
        d = shape_class_distance(shape_class, key[len(prefix):])
        if d < best_d:
            best, best_d = rec, d
    return dict(best["config"]) if best is not None else None
