"""The port's offline serve path held against the JAX reference on the CPU.

The reference's ``repro.launch.serve._measured_serve`` builds its weights
(``Model.init_params(PRNGKey(0))``) and prompts (``Model.make_inputs``)
itself; the test rebuilds the same two, carries them across, and feeds them
to the port's ``_measured_serve``. At ``matmul_precision="f32"`` the greedy
token ids must be identical, with either of the port's attention paths.
"""
import argparse
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.archs import get_arch as jax_get_arch
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig
from repro.distributed.steps import _effective_run
from repro.launch.serve import _measured_serve as jax_measured_serve
from repro.models.model import Model as JaxModel
from repro.serving.metrics import DecodeWindowMonitor as JaxMonitor
from repro_torch.configs.archs import get_arch
from repro_torch.configs.base import RunConfig
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.serving.metrics import DecodeWindowMonitor

ARGS = dict(arch="llama3.2-1b", smoke=True, batch=2, prompt_len=16, max_new=8,
            window_steps=3, model_parallel=1, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """(reference greedy ids, carried-over params, prompt tokens)."""
    args = argparse.Namespace(**ARGS)
    run = JaxRunConfig(mesh_model_parallel=1, matmul_precision="f32")
    _, _, ids = jax_measured_serve(run, args, JaxMonitor())
    model = JaxModel(jax_get_arch(args.arch, smoke=True),
                     _effective_run(run).replace(param_dtype=run.weight_dtype))
    params = model.init_params(jax.random.PRNGKey(0))
    batch = model.make_inputs(ShapeConfig("cli_prefill", args.prompt_len, args.batch, "prefill"))
    tp = params_from_jax(jax.tree.map(np.asarray, params), get_arch(args.arch, smoke=True))
    tokens = tensor_from_numpy(np.asarray(batch["tokens"])).long()
    return np.asarray(ids), tp, tokens


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_greedy_ids_identical_to_reference(reference, impl):
    ref_ids, params, tokens = reference
    args = argparse.Namespace(**ARGS)
    monitor = DecodeWindowMonitor(clock=time.perf_counter)
    t_prefill, t_decode, ids = serve._measured_serve(
        RunConfig(matmul_precision="f32", attention_impl=impl), args, monitor,
        params=params, tokens=tokens)
    assert ids.shape == (args.batch, args.max_new)
    assert ids.tolist() == ref_ids.tolist()
    assert t_prefill > 0 and t_decode > 0
    # 7 decode steps in windows of 3: 3 + 3 + 1
    assert [w.count for w in monitor.history] == [3, 3, 1]


def test_default_weights_are_seeded():
    args = argparse.Namespace(**dict(ARGS, max_new=3))
    run = RunConfig(matmul_precision="f32", attention_impl="torch")
    outs = [serve._measured_serve(run, args, DecodeWindowMonitor())[2] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_cli_offline_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--max-new", "4", "--window-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "prefill: 2×8 tokens" in out and "window 1:" in out


@pytest.mark.parametrize("flag", [["--online-tune"], ["--tuned-config", "x.json"]])
def test_cli_rejects_later_slices(flag):
    with pytest.raises(SystemExit, match="not ported yet"):
        serve.main(["--smoke", "--device", "cpu", *flag])
