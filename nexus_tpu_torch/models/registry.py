"""Model family registry (counterpart of ``nexus_tpu/models/registry.py``):
every family of the JAX package, ported."""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from nexus_tpu_torch.models import gptneox, llama, mixtral, mlp

_FAMILIES: Dict[str, ModuleType] = {"mlp": mlp, "llama": llama, "gptneox": gptneox,
                                    "mixtral": mixtral}


def get_family(name: str) -> ModuleType:
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; available: {sorted(_FAMILIES)}")
    return _FAMILIES[name]


def list_families():
    """Every family a spec may name."""
    return sorted(_FAMILIES)
