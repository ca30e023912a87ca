"""Rematerialisation of model blocks (counterpart of
``nexus_tpu/ops/remat.py``).

Only ``full`` (recompute the whole block on backward) is ported: it is
``torch.utils.checkpoint`` without re-entrance. The save-the-matmuls
policies ``dots`` and ``dots_attn`` have no counterpart yet and raise; they
never quietly become ``full``."""

from __future__ import annotations

from typing import Callable

from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ("full", "dots", "dots_attn")


def checkpoint_block(fn: Callable, remat_policy: str = "full") -> Callable:
    """Wrap ``fn`` so its activations are recomputed on backward."""
    if remat_policy == "full":
        def wrapped(*args):
            return checkpoint(fn, *args, use_reentrant=False)

        return wrapped
    if remat_policy in ("dots", "dots_attn"):
        raise ValueError(
            f"remat_policy {remat_policy!r} is not ported yet (ROADMAP 'Port to "
            "PyTorch/CUDA', item 2: remat dots/dots_attn); use 'full'"
        )
    raise ValueError(
        f"unknown remat_policy {remat_policy!r}; expected one of {REMAT_POLICIES}"
    )
