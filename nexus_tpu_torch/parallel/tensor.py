"""The collectives of the ``tensor`` axis: the ones GSPMD inserts in JAX
where a Megatron split of the projections needs them (the counterpart of
the placements ``nexus_tpu/parallel/sharding.py`` gives heads, mlp and
vocab).

A rank holds its block of the flat heads × head_dim columns of ``wq`` /
``wk`` / ``wv`` (and of the first layer of the MLP) and the matching rows
of ``wo`` (and of the MLP's second layer): each row-parallel product gives
a partial sum that ``reduce_from_tensor`` adds up over the ranks
(Megatron's *g*). Where the heads tile the axis the block is the rank's
whole heads, and attention runs on them as they are. Where they do not
(12 heads over 8 ranks: a rank holds one and a half), the rank gathers the
columns over the group (``gather_columns``), attends the whole heads its
block touches (its *span*, ``RankHeads``) and keeps its own columns of the
output for ``wo``. The
vocabulary is split too: ``vocab_parallel_embed`` looks up the rows of this
rank's range and sums, and ``gather_from_tensor`` assembles the logits of
every rank's range, so every rank samples from the same whole logits.

Training differentiates through them as ``torch.autograd.Function``s:
``reduce_from_tensor`` is an all-reduce forward and the identity backward
(each rank's partial product gets the whole gradient of the sum);
``copy_to_tensor`` (Megatron's *f*) is the identity forward and an
all-reduce backward, at the input of every column-parallel product, where
each rank's gradient holds its own heads' (or columns') share alone; the
embedding's backward sends each token's gradient to its owner's rows only;
``gather_columns``' backward sums the gradient of the gathered columns over
the group and keeps the rank's block (a reduce-scatter: each rank's
gradient covers only the columns its span consumed).
Under no autograd (decoding) each runs its forward alone: one collective
each, and none for *f*.

Each goes through ``parallel/comm.py``: under gloo a CUDA tensor is staged
through host memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from nexus_tpu_torch.parallel.comm import all_gather, all_reduce, reduce_scatter
from nexus_tpu_torch.parallel.mesh import active_mesh
from nexus_tpu_torch.parallel.sharding import HeadSpan, head_span


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


class _SpanGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, widths):
        ctx.group, ctx.widths = group, widths
        n = dist.get_world_size(group)
        whole = all_gather(x.contiguous(), group).view(n, *x.shape)
        return torch.cat([p.movedim(0, -2).reshape(*x.shape[:-1], n * p.shape[-1])
                          for p in whole.split(widths, dim=-1)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, widths = dist.get_world_size(ctx.group), ctx.widths
        parts = g.split([n * w for w in widths], dim=-1)
        by_rank = torch.cat([p.unflatten(-1, (n, w)).movedim(-2, 0)
                             for p, w in zip(parts, widths)], dim=-1)
        mine = reduce_scatter(by_rank, ctx.group)
        return mine.view(*g.shape[:-1], sum(widths)), None, None


def gather_columns(x: torch.Tensor, group, widths: Tuple[int, ...]) -> torch.Tensor:
    """The whole columns of several flat dims from every rank's blocks:
    ``x``'s last dim holds this rank's block of each dim in turn
    (``widths`` wide), and the result each whole dim in turn (every rank's
    block in rank order), in one all-gather. Its gradient is the sum of
    the whole gradient over the group, this rank's blocks kept (one
    reduce-scatter), where ``gather_from_tensor``'s keeps the rank's block
    of its own gradient alone."""
    return _SpanGather.apply(x, group, tuple(widths))


@dataclass(frozen=True)
class RankHeads:
    """The attention heads a tensor rank runs, from its blocks of the q and
    kv columns: ``q`` the whole q heads its block touches (the span), ``kv``
    the kv heads those q heads read (GQA: q head h reads kv head h //
    (n_heads / n_kv_heads)). Where the heads tile the axis the spans are
    the rank's own heads and nothing is gathered; else ``gather_q`` /
    ``gather_kv`` say which columns are gathered over ``group`` first.
    ``q_cols`` / ``kv_cols`` are the widths of the rank's blocks, ``size``
    the axis's ranks. ``kv_index``: where the span's q and kv heads break
    the kernels' group rule (q heads 2-4 with groups of 4 read kv heads 0,
    0, 1), the kv head of each q head, one kv head a q head; None when
    they keep it."""

    head_dim: int
    q: HeadSpan
    kv: HeadSpan
    q_cols: int
    kv_cols: int
    size: int = 1
    group: Any = None
    gather_q: bool = False
    gather_kv: bool = False
    kv_index: Optional[Tuple[int, ...]] = None

    @property
    def q_heads(self) -> int:
        return self.q.heads

    @property
    def kv_heads(self) -> int:
        """The kv heads the kernels read and a cache holds."""
        return self.kv.heads if self.kv_index is None else len(self.kv_index)

    def split(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """This rank's (B, S, columns) blocks of q, k and v → the span's
        (B, S, heads, D) q, k and v."""
        hd = self.head_dim
        b, s = q.shape[:2]
        if not self.gather_kv:
            return (q.reshape(b, s, self.q.heads, hd), k.reshape(b, s, self.kv.heads, hd),
                    v.reshape(b, s, self.kv.heads, hd))
        if self.gather_q:
            widths = (self.q_cols, self.kv_cols, self.kv_cols)
            q, k, v = gather_columns(torch.cat([q, k, v], -1), self.group, widths).split(
                [w * self.size for w in widths], -1)
            q = q[..., self.q.first * hd:(self.q.last + 1) * hd]
        else:
            k, v = gather_columns(torch.cat([k, v], -1), self.group,
                                  (self.kv_cols, self.kv_cols)).chunk(2, -1)
        cols = slice(self.kv.first * hd, (self.kv.last + 1) * hd)
        q, k, v = (t.reshape(b, s, -1, hd).contiguous() for t in (q, k[..., cols], v[..., cols]))
        if self.kv_index is not None:
            idx = torch.tensor(self.kv_index, device=k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return q, k, v

    def own(self, out: torch.Tensor) -> torch.Tensor:
        """The span's attention output (B, S, heads, D) → this rank's own
        columns of it (B, S, q columns), the rows of ``wo`` it holds."""
        flat = out.reshape(*out.shape[:2], -1)
        if not self.gather_q:
            return flat
        return flat[..., self.q.offset:self.q.offset + self.q_cols]


def rank_heads(n_heads: int, n_kv_heads: int, head_dim: int, rank: int = 0, size: int = 1,
               group=None) -> RankHeads:
    """The ``RankHeads`` of tensor rank ``rank`` of ``size`` (``group`` its
    tensor group) for a model of ``n_heads`` q and ``n_kv_heads`` kv heads
    of ``head_dim``."""
    group_size = n_heads // n_kv_heads
    q = head_span(n_heads, head_dim, rank, size)
    q_cols, kv_cols = n_heads * head_dim // size, n_kv_heads * head_dim // size
    if n_kv_heads % size == 0:  # then n_heads too: the rank's own heads
        return RankHeads(head_dim, q, head_span(n_kv_heads, head_dim, rank, size), q_cols,
                         kv_cols, size, group)
    reads = [h // group_size for h in range(q.first, q.last + 1)]
    kv = HeadSpan(reads[0], reads[-1], 0)
    rep = q.heads // kv.heads
    kept = q.heads % kv.heads == 0 and all(
        r - kv.first == i // rep for i, r in enumerate(reads))
    return RankHeads(head_dim, q, kv, q_cols, kv_cols, size, group, gather_q=n_heads % size != 0,
                     gather_kv=True,
                     kv_index=None if kept else tuple(r - kv.first for r in reads))
