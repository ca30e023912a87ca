"""The train state of a rank of sharded parameter axes (``fsdp``,
``expert``, ``tensor``) as the checkpoint formats see it: whole leaves,
gathered or cut one at a time (counterpart of the global arrays JAX's
checkpointer reads and writes under a mesh).

A step holds every leaf whole, as one device would write it. A save over
sharded parameter axes lets rank 0's writer read a ``GatheredLeaf`` in
place of each leaf the rules cut (its parameter and its two moments):
reading it gathers that leaf's blocks from the ranks of rank 0's group of
those axes and joins every cut (``ModelShard.join``), a leaf at a time, so
no rank holds more than one whole leaf beyond its own blocks. The writer may read the leaves in any
order and any number of times: before each gather rank 0 broadcasts the
leaf's index over the group's host group, and its peers, which run
``Gatherer.follow``, join that gather; a negative index ends the save.

A restore reads each whole leaf into host memory and keeps this rank's
block: a ``BlockTarget`` stands in for the rank's tensor, with the whole
leaf's shape, and ``copy_`` cuts the block out of what the reader read.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from nexus_tpu_torch.parallel.comm import all_gather
from nexus_tpu_torch.parallel.mesh import AXES
from nexus_tpu_torch.parallel.sharding import PARAM_AXES
from nexus_tpu_torch.train.trainer import OptState, TrainState, leaf_paths


class GatheredLeaf:
    """A leaf whose blocks the parameter axes' ranks hold, as a writer reads
    it: its whole ``shape``, ``dtype`` and ``device``, and ``whole()``, the
    gather (a collective that rank 0's group of those axes joins)."""

    def __init__(self, gatherer: "Gatherer", index: int, block: torch.Tensor):
        self.gatherer = gatherer
        self.index = index
        self.shape = gatherer.whole_shape(index)
        self.dtype = block.dtype
        self.device = block.device

    def whole(self) -> torch.Tensor:
        return self.gatherer.fetch(self.index)


class BlockTarget:
    """A rank's block of a leaf as a restore target: the whole leaf's
    ``shape`` and the block's ``dtype``; ``copy_(whole)`` keeps the block."""

    def __init__(self, block: torch.Tensor, take: Callable[[torch.Tensor], torch.Tensor],
                 shape):
        self.block = block
        self.take = take
        self.shape = tuple(shape)
        self.dtype = block.dtype

    @torch.no_grad()
    def copy_(self, whole: torch.Tensor) -> None:
        self.block.copy_(self.take(whole))


def is_array(x) -> bool:
    """A tensor leaf, or one of this module's stand-ins for one."""
    return torch.is_tensor(x) or isinstance(x, (GatheredLeaf, BlockTarget))


def materialize(x):
    """The tensor a writer writes for ``x``: a gathered leaf's whole."""
    return x.whole() if isinstance(x, GatheredLeaf) else x


def _map_tree(tree, f):
    if isinstance(tree, dict):
        return {k: _map_tree(v, f) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, f) for v in tree]
    return f(tree)


def stand_in(state, wrap: Callable[[int, torch.Tensor, str], Any]):
    """``state`` with the parameter and the moments of every cut leaf
    replaced by ``wrap(index, tensor,
    path)``: the index counts the parameters, then the first moments, then
    the second. The counts and the step are copied."""
    paths = leaf_paths(state.params, state.leaves)
    n = len(paths)

    def replace(tensors, offset):
        return [wrap(offset + i, t, p) if c else t
                for i, (t, p, c) in enumerate(zip(tensors, paths, state.cut))]

    leaves = replace(state.leaves, 0)
    new = {id(old): x for old, x in zip(state.leaves, leaves)}
    opt = state.opt_state
    return TrainState(_map_tree(state.params, lambda t: new.get(id(t), t)), leaves,
                      OptState(mu=replace(opt.mu, n), nu=replace(opt.nu, 2 * n),
                               count=opt.count, schedule_count=opt.schedule_count),
                      state.step)


class Gatherer:
    """The leaf-at-a-time gathers of one save over sharded parameter axes,
    on every rank: rank 0 drives them through ``proxy()``'s leaves and ends
    them with ``done()``; the other ranks of its group of those axes
    ``follow()``; the rest of the world takes no part (``follows`` is
    False)."""

    def __init__(self, state, mesh):
        self.state = state
        self.cuts = state.cuts
        self.paths = leaf_paths(state.params, state.leaves)
        opt = state.opt_state
        self.tensors: List[torch.Tensor] = list(state.leaves) + list(opt.mu) + list(opt.nu)
        self.size = mesh.size(*PARAM_AXES)
        self.group = mesh.group(*PARAM_AXES)
        self.host = mesh.host_group(*PARAM_AXES)
        self.follows = all(mesh.index(a) == 0 for a in AXES if a not in PARAM_AXES)

    def whole_shape(self, index: int) -> tuple:
        return self.cuts.whole_shape(self.paths[index % len(self.paths)],
                                     self.tensors[index].shape)

    def _agree(self, index: int) -> int:
        t = torch.tensor([index], dtype=torch.int64)
        dist.broadcast(t, group=self.host, group_src=0)
        return int(t.item())

    def _gather(self, index: int) -> torch.Tensor:
        block = self.tensors[index].detach().contiguous()
        blocks = all_gather(block, self.group).view(self.size, *block.shape)
        return self.cuts.join(self.paths[index % len(self.paths)], list(blocks.unbind(0)))

    def fetch(self, index: int) -> torch.Tensor:
        self._agree(index)
        return self._gather(index)

    def follow(self) -> None:
        while (index := self._agree(-1)) >= 0:
            self._gather(index)

    def done(self) -> None:
        self._agree(-1)

    def proxy(self):
        """The state as rank 0's writer reads it."""
        return stand_in(self.state, lambda i, t, p: GatheredLeaf(self, i, t))


def block_targets(state):
    """``state`` as a restore target: each cut tensor a ``BlockTarget`` of
    its whole leaf."""
    cuts = state.cuts
    return stand_in(state, lambda i, t, p: BlockTarget(t, cuts.take(p),
                                                       cuts.whole_shape(p, t.shape)))
