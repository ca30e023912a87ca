"""The collectives of the ``tensor`` axis: the ones GSPMD inserts in JAX
where a Megatron split of the projections needs them (the counterpart of
the placements ``nexus_tpu/parallel/sharding.py`` gives heads, mlp and
vocab).

A rank holds the columns of its heads in ``wq`` / ``wk`` / ``wv`` (and the
first layer of the MLP) and the matching rows of ``wo`` (and of the MLP's
second layer): each row-parallel product gives a partial sum that
``reduce_from_tensor`` adds up over the ranks (Megatron's *g*). The
vocabulary is split too: ``vocab_parallel_embed`` looks up the rows of this
rank's range and sums, and ``gather_from_tensor`` assembles the logits of
every rank's range, so every rank samples from the same whole logits.

Training differentiates through them as ``torch.autograd.Function``s:
``reduce_from_tensor`` is an all-reduce forward and the identity backward
(each rank's partial product gets the whole gradient of the sum);
``copy_to_tensor`` (Megatron's *f*) is the identity forward and an
all-reduce backward, at the input of every column-parallel product, where
each rank's gradient holds its own heads' (or columns') share alone; the
embedding's backward sends each token's gradient to its owner's rows only.
Under no autograd (decoding) each runs its forward alone: one collective
each, and none for *f*.

Each goes through ``parallel/comm.py``: under gloo a CUDA tensor is staged
through host memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from nexus_tpu_torch.parallel.comm import all_gather, all_reduce
from nexus_tpu_torch.parallel.mesh import active_mesh


def tensor_mesh(size: int):
    """The active mesh, whose ``tensor`` axis must have ``size`` ranks (the
    degree a sharded model's weights were cut for); raises when no mesh
    with such an axis is active."""
    mesh = active_mesh()
    have = 1 if mesh is None else mesh.shape["tensor"]
    if have != size:
        raise ValueError(f"the weights are cut for {size} tensor ranks but the active mesh "
                         f"has {have} (run inside parallel.mesh.use_mesh of the mesh they "
                         "were sharded for)")
    return mesh


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over the tensor group (after a
    row-parallel product); the gradient passes through unchanged. ``x``
    itself without a group."""
    return x if group is None else _Reduce.apply(x, group)


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over the tensor group) as the input of a
    column-parallel product: the identity, whose gradient is summed over
    the group. ``x`` itself without a group."""
    return x if group is None else _Copy.apply(x, group)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor, group,
                         dtype: torch.dtype) -> torch.Tensor:
    """The embedding rows of ``tokens`` (B, T) from ``embed``, this rank's
    block of the vocabulary: rows of its range, zeros for the others, then
    the sum over the group, so each token's row is its owner's exactly.
    Without a group, the plain lookup of the whole table."""
    table = embed.to(dtype)
    if group is None:
        return table[tokens.long()]
    n = table.shape[0]
    local = tokens.long() - dist.get_rank(group) * n
    inside = ((local >= 0) & (local < n))[..., None]
    rows = table[local.clamp(0, n - 1)]
    return reduce_from_tensor(torch.where(inside, rows, torch.zeros_like(rows)), group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        whole = all_gather(x.contiguous(), group).view(n, *x.shape)
        return whole.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=-1)[dist.get_rank(ctx.group)].contiguous(), None


def gather_from_tensor(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Every rank's block of the last dim of ``x``, joined in rank order:
    this rank's (B, T, V / n) logits → the whole (B, T, V) on every rank.
    Its gradient is the rank's block of the whole one's: what follows runs
    alike on every rank (a column-parallel product takes it through
    ``copy_to_tensor``, which sums the ranks' shares). ``x`` itself without
    a group."""
    return x if group is None else _Gather.apply(x, group)
