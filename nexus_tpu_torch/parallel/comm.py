"""Collectives of the port: its counterparts of ``lax.ppermute`` and
``psum`` and of the gradient collectives GSPMD inserts in JAX.

``ring_shift`` moves a tensor one step around a group's ring (rank i sends
to i + 1) as a ``torch.autograd.Function``: its backward shifts the
gradient the other way, the transpose of ``ppermute``, so a key/value block
that visited another rank gets its gradient back on its own.

The host agreements (``AgreedClock``, ``agree_any``, ``check_lockstep``)
keep ranks that run one host program in lockstep: every rank must take the
same host decisions, or the next collective waits for a peer that went
elsewhere. They run over a gloo group (``Mesh.host_group``) on host values.

A group's backend decides where a collective runs. NCCL runs on the card.
Gloo runs on the host: a CUDA tensor is copied into a host buffer, the
collective runs there, and the result is copied back. Several ranks can
share one card only over gloo: NCCL refuses two ranks on one card, and
``check_backend`` raises before it is asked to, never switching backends.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List

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
    """``x`` where the group's collectives take it, contiguous: a host copy
    of a CUDA tensor under gloo, else ``x`` itself. A collective runs over
    the buffer in memory order, so two ranks whose tensors of one shape
    are laid out otherwise (an einsum's output strides follow its
    operands' shapes) would combine unlike elements: the copy is always
    row-major."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu").contiguous()
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


def all_reduce(x: torch.Tensor, group, mean: bool = False,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or mean, or another ``op``) of ``x`` over ``group``, on
    ``x``'s device; ``x`` itself when the group is None (one rank)."""
    if group is None:
        return x
    buf = _wire(x, group)
    if buf is x:
        buf = x.clone()
    return _all_reduce_(buf, group, mean, op).to(x.device)


def _all_reduce_(buf: torch.Tensor, group, mean: bool, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(buf, op=op, group=group)
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


class AgreedClock:
    """A clock every rank of ``group`` reads alike: rank 0's reading,
    broadcast at each read. Every rank must read it the same number of
    times in the same order (it is a collective)."""

    def __init__(self, clock: Callable[[], float], group):
        self.clock = clock
        self.group = group

    def __call__(self) -> float:
        t = torch.tensor([self.clock() if dist.get_rank(self.group) == 0 else 0.0],
                         dtype=torch.float64)
        dist.broadcast(t, group=self.group, group_src=0)
        return float(t.item())


def agree_any(flag: bool, group) -> bool:
    """True on every rank of ``group`` when it is true on any."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def digest64(*parts) -> int:
    """A 64-bit digest of ``parts`` (bytes, or anything whose ``repr`` is
    stable), as a signed integer."""
    h = hashlib.blake2b(digest_size=8)
    for part in parts:
        h.update(part if isinstance(part, (bytes, bytearray)) else repr(part).encode())
    return int.from_bytes(h.digest(), "little", signed=True)


def check_lockstep(digest: int, group, what: str) -> None:
    """All-gather every rank's ``digest`` of its host state and raise
    ``AssertionError`` on every rank when they differ: ranks that diverged
    fail here together instead of waiting in a collective for a peer that
    went elsewhere."""
    t = torch.tensor([digest], dtype=torch.int64)
    out = torch.empty(dist.get_world_size(group), dtype=torch.int64)
    dist.all_gather_into_tensor(out, t, group=group)
    seen = out.tolist()
    if len(set(seen)) > 1:
        raise AssertionError(f"lockstep audit ({what}): the ranks' host states diverged; "
                             f"digests by rank {seen}")
