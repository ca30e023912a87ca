"""Model family registry (counterpart of ``nexus_tpu/models/registry.py``).
Only ``llama`` is ported; the other families of the JAX package raise."""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from nexus_tpu_torch.models import llama

_FAMILIES: Dict[str, ModuleType] = {"llama": llama}
_NOT_PORTED = ("mlp", "mixtral", "gptneox")


def get_family(name: str) -> ModuleType:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet (ROADMAP 'Port to "
            "PyTorch/CUDA', item 3); available: ['llama']"
        )
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; available: {sorted(_FAMILIES)}")
    return _FAMILIES[name]

