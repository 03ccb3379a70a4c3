"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled, one ``nvcc``
process per source, all started together, into its own shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <source>

The libraries go to ``build/repro_torch/`` at the repository root, named by
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. The package must therefore run from a source
checkout (``src/repro_torch``); an installed copy raises at build time. ``torch.utils.cpp_extension.load`` is not used: a
source that includes PyTorch's headers takes minutes to compile, a plain C
one seconds.

Nothing here runs at import time. The first kernel launch calls
:func:`library`; a missing ``nvcc`` or a compile error raises. Sources come
only from this package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

KERNELS_DIR = Path(__file__).resolve().parent


def checkout_build_dir(kernels_dir: Path) -> Optional[Path]:
    """``<checkout>/build/repro_torch`` when ``kernels_dir`` is
    ``<checkout>/src/repro_torch/kernels``, else None (an installed copy)."""
    src = kernels_dir.parents[1]
    return src.parent / "build" / "repro_torch" if src.name == "src" else None


BUILD_DIR = checkout_build_dir(KERNELS_DIR)
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr per source (ptxas: registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}


def sources() -> Dict[str, Path]:
    """``{stem: path}`` of every CUDA source of the package."""
    out = {}
    for path in sorted(KERNELS_DIR.glob("*/csrc/*.cu")):
        if path.stem in out:
            raise RuntimeError(f"two CUDA sources named {path.stem!r}")
        out[path.stem] = path
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built at first "
        "launch and need the CUDA toolkit (put nvcc on PATH)"
    )


def _target(stem: str, src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    ``{stem: library path}``. Raises on the first failed compile."""
    if BUILD_DIR is None:
        raise RuntimeError(
            f"repro_torch builds its CUDA kernels into build/ of a source "
            f"checkout, but {KERNELS_DIR} is not under <checkout>/src: run it "
            f"from a checkout with PYTHONPATH=src"
        )
    todo, out = {}, {}
    for stem, src in sources().items():
        out[stem] = _target(stem, src)
        if not out[stem].exists():
            todo[stem] = src
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, src in todo.items():
        # compile to a private name, then rename: a concurrent builder never
        # loads a half-written library
        tmp = out[stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for stem, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_LOG[stem] = stdout + stderr
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {todo[stem]} (rc={proc.returncode}):\n"
                          f"{stderr[-4000:]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[stem])
            out[stem].with_suffix(".log").write_text(BUILD_LOG[stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no CUDA source named {stem!r}")
            lib = _libs[stem] = ctypes.CDLL(str(paths[stem]))
        return lib
