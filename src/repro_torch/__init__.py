"""PyTorch / CUDA port of the ``repro`` auto-tuning system, for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against; the
port imports nothing from it (not even its stdlib-only modules) and keeps its
own copies of what it needs. Module names and public tensor layouts follow the
reference so a reader finds each counterpart: attention takes
``(B, S, H, Dh)``, weights are ``(d_in, d_out)``.

Slice 1 covers the offline serving path of the dense models: configs, the
hand-written CUDA flash-attention forward used in prefill, the dense
transformer, the single-device step builders, the decode-window metrics and
``launch/serve.py``.

Importing this package needs neither CUDA nor ``nvcc``: kernels are built at
their first launch (:mod:`repro_torch.kernels._build`).
"""
from repro_torch.device import resolve_device, synchronize

__all__ = ["resolve_device", "synchronize"]
