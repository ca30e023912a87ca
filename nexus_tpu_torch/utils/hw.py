"""Device resolution and host synchronisation (counterpart of
``nexus_tpu/utils/hw.py``; platform forcing and the compilation cache are
JAX-only and have no counterpart here).

Entry points run on CUDA unless the caller asks for the CPU: a missing card
is an error, never a quiet fall back to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU; any CUDA device string as
    given. Raises RuntimeError when CUDA is asked for (or defaulted to) and
    no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_kind(device: Optional[Union[str, torch.device]] = None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def sync_host(device: Union[str, torch.device]) -> None:
    """Close a host-side timing window: wait for the device's queued work."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
