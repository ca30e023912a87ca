"""Collectives of the port: its counterparts of ``lax.ppermute`` and
``psum`` and of the gradient collectives GSPMD inserts in JAX.

``ring_shift`` moves a tensor one step around a group's ring (rank i sends
to i + 1) as a ``torch.autograd.Function``: its backward shifts the
gradient the other way, the transpose of ``ppermute``, so a key/value block
that visited another rank gets its gradient back on its own.

A group's backend decides where a collective runs. NCCL runs on the card.
Gloo runs on the host: a CUDA tensor is copied into a host buffer, the
collective runs there, and the result is copied back. Several ranks can
share one card only over gloo: NCCL refuses two ranks on one card, and
``check_backend`` raises before it is asked to, never switching backends.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist


def check_backend(backend: str, world: int, device_count: int) -> None:
    """Raise when ``backend`` cannot run ``world`` ranks over
    ``device_count`` cards: NCCL with two ranks on one card."""
    if backend == "nccl" and world > device_count:
        raise ValueError(
            f"backend 'nccl' cannot run {world} ranks on {device_count} card(s): NCCL refuses "
            "two ranks on one card; use backend 'gloo', which stages each collective "
            "through host memory")


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where the group's collectives take it: a host copy of a CUDA
    tensor under gloo, else ``x`` itself (contiguous)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu")
    return x.contiguous()


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i of ``group`` receives rank i - step's ``x``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    send = _wire(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, group=group, group_peer=(me + step) % n),
           dist.P2POp(dist.irecv, recv, group=group, group_peer=(me - step) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i of ``group`` receives rank i - 1's ``x``; differentiable."""
    return _RingShift.apply(x, group)


def by_dtype(tensors: List[torch.Tensor]) -> List[List[int]]:
    """The indices of ``tensors`` grouped by dtype, in first-seen order: the
    buckets that one collective each moves."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def all_reduce(x: torch.Tensor, group, mean: bool = False) -> torch.Tensor:
    """The sum (or mean) of ``x`` over ``group``, on ``x``'s device; ``x``
    itself when the group is None (one rank)."""
    if group is None:
        return x
    buf = _wire(x, group)
    if buf is x:
        buf = x.clone()
    return _all_reduce_(buf, group, mean).to(x.device)


def _all_reduce_(buf: torch.Tensor, group, mean: bool) -> torch.Tensor:
    dist.all_reduce(buf, group=group)
    return buf / dist.get_world_size(group) if mean else buf


def all_reduce_coalesced(tensors: List[torch.Tensor], group,
                         mean: bool = False) -> List[torch.Tensor]:
    """``all_reduce`` of each tensor, as one collective a dtype over a flat
    buffer of them all."""
    if group is None:
        return list(tensors)
    out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore[list-item]
    for idx in by_dtype(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = _all_reduce_(_wire(flat, group), group, mean).to(flat.device)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the sum of ``x`` over ``group``: the flattened
    ``x`` splits into group-size equal blocks, rank i keeps block i."""
    buf = _wire(x, group).reshape(-1)
    out = torch.empty(buf.numel() // dist.get_world_size(group), dtype=buf.dtype,
                      device=buf.device)
    dist.reduce_scatter_tensor(out, buf, group=group)
    return out.to(x.device)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, flattened and concatenated in
    rank order."""
    buf = _wire(x, group).reshape(-1)
    out = torch.empty(buf.numel() * dist.get_world_size(group), dtype=buf.dtype,
                      device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=group)
    return out.to(x.device)
