"""Device resolution and synchronisation.

Entry points run on the card. ``resolve_device(None)`` or ``"cuda"`` returns
the CUDA device and raises when there is none; the CPU is used only when the
caller asks for it by name (the CPU tests do). There is no silent fallback:
a run that was meant for the card and landed on the CPU would report CPU
times under device names.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` → that CUDA device (raises without
    one); ``"cpu"`` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")


def synchronize(device: Optional[torch.device] = None) -> None:
    """Wait until queued work on ``device`` has finished — the counterpart of
    ``jax.block_until_ready``. A no-op on the CPU, where torch runs eagerly."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
