"""Weights carried across from the JAX reference.

``params_from_jax(tree, arch)`` takes the reference's parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's tree. Both keep weights as ``(d_in, d_out)``, so each leaf
is a copy, not a transpose; the reference's stacked group axis
(``tree["stack"]["l{j}"][...]`` with a leading ``num_groups`` axis) is split
into one dict per layer.

bf16 arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects; they go through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm


def tensor_from_numpy(a) -> torch.Tensor:
    """One numpy array (ml_dtypes bf16 included) → a torch tensor of the same
    dtype and values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def unstack_layers(stack: Dict[str, Any], num_layers: int) -> List[Dict[str, Any]]:
    """The reference's ``{"l{j}": leaves with a leading group axis}`` →
    one dict per layer: layer ``i`` is group ``i // period``, member
    ``i % period``."""
    period = len(stack)
    return [_tree(stack[f"l{i % period}"], lambda a, g=i // period: a[g])
            for i in range(num_layers)]


def params_from_jax(tree: Dict[str, Any], arch: ArchConfig) -> Dict[str, Any]:
    """The port's parameter tree (CPU tensors) from the reference's."""
    tfm.check_supported(arch)
    out = {
        "embed": tensor_from_numpy(tree["embed"]),
        "layers": [_tree(layer, tensor_from_numpy)
                   for layer in unstack_layers(tree["stack"], arch.num_layers)],
        "final_norm": tensor_from_numpy(tree["final_norm"]),
    }
    if "unembed" in tree:
        out["unembed"] = tensor_from_numpy(tree["unembed"])
    return out
