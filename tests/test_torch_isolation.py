"""The port stands alone: it imports neither JAX nor the reference package,
its entry points refuse to run on the CPU unless asked, and the repo's
linter stays clean over it."""
import argparse
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import device as port_device

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    banned = [m for m in _imports(path)
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not banned, f"{path} imports {banned}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_device.resolve_device(dev)
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        port_device.resolve_device("mps")


def test_serve_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve
    from repro_torch.serving.metrics import DecodeWindowMonitor

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--max-new", "2"])
    args = argparse.Namespace(arch="llama3.2-1b", smoke=True, batch=1, prompt_len=4,
                              max_new=2, window_steps=1, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve._measured_serve(RunConfig(), args, DecodeWindowMonitor())


def test_build_raises_without_nvcc(monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", Path("/nonexistent/nvcc"))
    monkeypatch.setattr(_build, "sources", lambda: {"flash_fwd": REPO / "missing.cu"})
    monkeypatch.setattr(_build, "_target", lambda stem, src: Path("/nonexistent/x.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_build_dir_is_the_checkouts(monkeypatch):
    """Libraries land in build/ of a source checkout; an installed copy of
    the package has none, and its first build raises instead of writing
    beside site-packages."""
    from repro_torch.kernels import _build

    assert _build.BUILD_DIR == REPO / "build" / "repro_torch"
    installed = Path("/venv/lib/python3.12/site-packages/repro_torch/kernels")
    assert _build.checkout_build_dir(installed) is None
    monkeypatch.setattr(_build, "BUILD_DIR", None)
    with pytest.raises(RuntimeError, match="source checkout"):
        _build.build_all()


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc (a shell script) plus a private source and build dir:
    drives build_all's process handling without a CUDA toolkit."""
    from repro_torch.kernels import _build

    src = tmp_path / "demo.cu"
    src.write_text("// demo\n")
    nvcc = tmp_path / "nvcc"
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "sources", lambda: {"demo": src})

    def install(script: str):
        nvcc.write_text("#!/bin/sh\n" + script)
        nvcc.chmod(0o755)
    return _build, src, install


def test_build_compiles_once_keyed_by_source(fake_nvcc):
    build, src, install = fake_nvcc
    # write the file named after -o, echo a ptxas-like line to stderr
    install('while [ "$1" != "-o" ]; do shift; done; echo built > "$2"; '
            'echo "ptxas info: 40 registers" >&2\n')
    first = build.build_all()["demo"]
    assert first.exists() and first.parent == build.BUILD_DIR
    assert "40 registers" in build.BUILD_LOG["demo"]
    install("exit 3\n")  # a rebuild would now fail: the library is reused
    assert build.build_all()["demo"] == first
    src.write_text("// edited\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_all()  # a new source hash needs a new build
    assert list(build.BUILD_DIR.glob("*.tmp")) == []


def test_every_cuda_source_is_found():
    from repro_torch.kernels import _build

    assert set(_build.sources()) == {"flash_fwd", "ssm_scan"}


def test_reprolint_clean_over_src():
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "reprolint.py"),
                           str(REPO / "src")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
