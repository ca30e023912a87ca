"""Rematerialisation of model blocks (counterpart of
``nexus_tpu/ops/remat.py``): one place maps the spec's ``remat_policy``
onto ``torch.utils.checkpoint`` (non-reentrant), and an unknown policy is
a loud error, never a quiet ``full``.

``full``: recompute the whole block on backward.
``dots``: keep the outputs of the matrix products with no batch dims
(``aten.mm`` / ``aten.addmm``: the projections and the router), recompute
the rest. JAX's ``dots_with_no_batch_dims_saveable`` in PyTorch terms: the
experts' batched products (``aten.bmm``) are recomputed, as in JAX.
``dots_attn``: ``dots`` plus the attention output: on the flash path the
flash forward's (out, lse) — the op ``nexus::flash_fwd`` — so backward
runs the dQ and dK/dV kernels without launching K1 again; on the dense
path the PV product — the op ``nexus::attn_out`` — so the recompute
reruns the scores and softmax the backward reads, and not the product.

The JAX blocks name their attention output (``ATTN_OUT_NAME``) and XLA
drops whatever recompute no saved value needs. A PyTorch recompute
replays a block's ops in order, and what a saved op skips is that op
itself: a tag placed after attention would skip nothing. The attention's
last op is therefore the tag, and the policy names it.

Collectives inside a block (a model-axes rank's, parallel/tensor.py):
the recompute replays the forward's ``reduce_from_tensor`` all-reduces
that lie before the last tensor the backward needs, under every policy (a
non-reentrant recompute stops there; ``dots`` / ``dots_attn`` keep the
products' outputs, the partial sums before each reduce, not the reduces,
which are no products). A Llama layer replays the reduce after ``wo`` (its
sum feeds the MLP's norm, whose backward needs it), not the one after
``w_down``; a GPT-NeoX layer's one reduce is its last op, replayed by no
policy. A Mixtral layer (models/mixtral.py) runs up to three
collectives forward: the reduce after ``wo`` (a tensor axis), the
all-gather of the routing's expert indices over the batch axes
(ops/moe.py::global_top_k_routing) and the reduce of the MoE layer's
partial outputs over the model axes (expert, tensor). Every policy
replays the first two (the MoE norm's backward needs the attention's sum;
the dispatch's and the combine's backward need the slots) and none the
last, whose sum only feeds the residual add; ``dots`` and ``dots_attn``
keep the router's product (an ``aten.mm``), not the experts' (``aten.bmm``).
``copy_to_tensor`` runs no collective forward; its all-reduce runs
once, in the backward. Every rank replays the same collectives in the
same order: a block's recompute runs when its first saved tensor is
unpacked, at the same point of every rank's identical backward. GSPMD's
recompute in JAX saves the same dot outputs by name and reruns what the
backward needs after them. Ring attention's shifts (ops/ring_attention.py)
come before the attention's saved outputs, so every policy replays them
too, ``dots_attn`` keeping only the flash forward's outputs.

Under a tensor axis whose heads do not tile it (parallel/tensor.py::
RankHeads) a block gathers the q / kv columns over the tensor group before
the attention, and slices the rank's own columns of the attention's
output after it. The gather comes before the attention's saved outputs,
so every policy replays it, in the same order on every rank; ``dots_attn``
keeps the attention's own output at the span's heads (K1's out and lse,
or the dense path's PV product), and the slice, a view of it, is
recomputed. The gather's backward (a reduce-scatter) runs once, in the
block's backward.

Under a sharded ``fsdp`` axis a block's first collective is the gather of
its layer's weights (parallel/fsdp.py: one all-gather a dtype, inside the
wrapped function): everything after it reads the whole weights, so every
policy replays it, first, in every rank's recompute, in the same order as
the forward ran it, and before the block's other collectives (the tensor
reduces, the ring's shifts, Mixtral's index all-gather). What the block's
recompute gathers lives until that layer's backward is done; the gather's
backward reduce-scatters the weights' gradients as the block's last
collective. Outside a wrapped block (remat off) the trainer's
``saved_as_blocks`` keeps each saved whole weight as its block and the
backward gathers it again where it unpacks it.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, FrozenSet

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from nexus_tpu_torch.ops import attention  # noqa: F401 (registers the nexus:: ops)

REMAT_POLICIES = ("full", "dots", "dots_attn")

# the products with no batch dims: what 'dots' keeps
DOT_OPS: FrozenSet = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
# ...and the attention output, which 'dots_attn' keeps too: the flash
# forward's (out, lse), or the dense path's PV product
ATTN_OPS: FrozenSet = frozenset({torch.ops.nexus.flash_fwd.default,
                                 torch.ops.nexus.attn_out.default})


def _saving(ops: FrozenSet):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


_SAVED = {"dots": DOT_OPS, "dots_attn": DOT_OPS | ATTN_OPS}


def checkpoint_block(fn: Callable, remat_policy: str = "full") -> Callable:
    """Wrap ``fn`` so its activations are recomputed on backward, but for
    what ``remat_policy`` keeps."""
    if remat_policy == "full":
        context_fn = None
    elif remat_policy in _SAVED:
        context_fn = partial(create_selective_checkpoint_contexts, _saving(_SAVED[remat_policy]))
    else:
        raise ValueError(
            f"unknown remat_policy {remat_policy!r}; expected one of {REMAT_POLICIES}"
        )

    def wrapped(*args):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped
