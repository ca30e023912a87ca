"""Model family registry (counterpart of ``nexus_tpu/models/registry.py``).
``llama`` and ``mixtral`` are ported; the other families of the JAX
package raise."""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from nexus_tpu_torch.models import llama, mixtral

_FAMILIES: Dict[str, ModuleType] = {"llama": llama, "mixtral": mixtral}
_NOT_PORTED = ("mlp", "gptneox")


def get_family(name: str) -> ModuleType:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet (ROADMAP 'Port to "
            f"PyTorch/CUDA', item 3); available: {sorted(_FAMILIES)}"
        )
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; available: {sorted(_FAMILIES)}")
    return _FAMILIES[name]


def list_families():
    """Every family the JAX package has, ported or not (a spec may name
    any; ``get_family`` raises for those not ported yet)."""
    return sorted((*_FAMILIES, *_NOT_PORTED))
