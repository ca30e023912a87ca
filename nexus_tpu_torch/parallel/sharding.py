"""Sharding rules (counterpart of ``nexus_tpu/parallel/sharding.py``).

``DEFAULT_LOGICAL_RULES`` and ``logical_to_spec`` are JAX's map of logical
tensor dims onto mesh axes. The port applies them by hand:

* ``batch_spec`` cuts this rank's slice out of the global batch (rows over
  ``data`` and ``fsdp``, columns over ``sequence``);
* ``shard_params`` cuts this rank's block out of every parameter along the
  dims the rules put on ``tensor`` (heads, kv heads, qkv, mlp, vocab), as
  JAX's ``shard_params`` places them. A fused leaf may cut each of several
  equal runs of a dim in turn (GPT-NeoX's ``wqkv``: q, k and v thirds, each
  by head). ``TensorShard.join`` is the inverse: every rank's block of a
  leaf back into the whole leaf (what a checkpoint holds). The other axes
  keep parameters whole on every rank; the trainer shards the optimizer
  state over ``fsdp`` (train/trainer.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nexus_tpu_torch.models.params import LeafCuts
from nexus_tpu_torch.parallel.mesh import Mesh

# logical dim name → physical mesh axis (or tuple of axes)
DEFAULT_LOGICAL_RULES: Dict[Any, Any] = {
    "batch": ("data", "fsdp"),
    "seq": "sequence",
    "vocab": "tensor",
    "embed": "fsdp",
    "mlp": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "qkv": "tensor",
    "expert": "expert",
    "norm": None,
    "layer": None,
    None: None,
}


def logical_to_spec(logical_dims: Tuple[Optional[str], ...],
                    rules: Optional[Dict[Any, Any]] = None) -> Tuple[Any, ...]:
    """("vocab", "embed") → ("tensor", "fsdp"): JAX's PartitionSpec as a
    tuple."""
    rules = rules or DEFAULT_LOGICAL_RULES
    return tuple(rules.get(d) for d in logical_dims)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def batch_spec(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, np.ndarray]:
    """This rank's slice of a global batch: rows split over ``data`` ×
    ``fsdp`` (data outer, as JAX's ``P(("data", "fsdp"))`` lays them), and
    the (B, S+1) ``tokens`` columns over ``sequence``. The input/target
    shift is taken before the cut: a rank keeps S/n + 1 columns, the
    inputs of its S/n positions and their targets, one past its block."""
    dp = mesh.size("data", "fsdp")
    rows = _block(next(iter(batch.values())).shape[0], dp,
                  mesh.index("data") * mesh.shape["fsdp"] + mesh.index("fsdp"), "batch")
    out = {k: x[rows] for k, x in batch.items()}
    n_seq = mesh.shape["sequence"]
    if "tokens" in out and n_seq > 1:
        tokens = out["tokens"]
        cols = _block(tokens.shape[1] - 1, n_seq, mesh.index("sequence"), "sequence")
        out["tokens"] = tokens[:, cols.start:cols.stop + 1]
    return out


@dataclass(frozen=True)
class TensorShard:
    """This rank's place on the ``tensor`` axis: block ``rank`` of ``size``
    of every dim the rules put on it."""

    rank: int
    size: int

    def _cut_dims(self, dims: Tuple[Optional[str], ...], ndim: int) -> list:
        """The positions, among the ``ndim`` trailing dims of ``dims``, that
        ``logical_to_spec`` puts on ``tensor``."""
        return [i for i, axis in enumerate(logical_to_spec(tuple(dims)[len(dims) - ndim:]))
                if axis == "tensor"]

    def take(self, x: torch.Tensor, dims: Tuple[Optional[str], ...],
             groups: int = 1) -> torch.Tensor:
        """This rank's block of ``x``, a whole tensor whose dims are the
        trailing ones of ``dims`` (a stacked leaf or one layer of it): each
        dim on ``tensor`` is read as ``groups`` equal runs, and the rank
        keeps its block of each run, in order."""
        for i in self._cut_dims(dims, x.dim()):
            n = x.shape[i]
            if n % (groups * self.size):
                raise ValueError(f"dim {dims[len(dims) - x.dim() + i]!r} of {n} does not split "
                                 f"into {groups} run(s) over {self.size} tensor ranks")
            x = x.unflatten(i, (groups, self.size, n // (groups * self.size)))
            x = x.select(i + 1, self.rank).flatten(i, i + 1)
        return x

    def join(self, blocks: Sequence[torch.Tensor], dims: Tuple[Optional[str], ...],
             groups: int = 1) -> torch.Tensor:
        """The whole tensor from every rank's block (``blocks`` in rank
        order, one per rank of the axis): the inverse of ``take``, fused
        runs included. A tensor with no dim on ``tensor`` is the same
        on every rank: rank 0's block is the whole."""
        if len(blocks) != self.size:
            raise ValueError(f"{len(blocks)} blocks for {self.size} tensor ranks")
        cut = self._cut_dims(dims, blocks[0].dim())
        if not cut:
            return blocks[0]
        if len(cut) > 1:
            raise ValueError(f"dims {dims} put {len(cut)} dims on tensor: a rank's blocks do "
                             "not tile such a tensor")
        i = cut[0]
        n = blocks[0].shape[i]
        if n % groups:
            raise ValueError(f"dim {dims[len(dims) - blocks[0].dim() + i]!r} of {n} does not "
                             f"split into {groups} run(s)")
        runs = [b.unflatten(i, (groups, n // groups)) for b in blocks]
        return torch.stack(runs, dim=i + 1).flatten(i, i + 2)

    def whole_shape(self, shape: Tuple[int, ...], dims: Tuple[Optional[str], ...]
                    ) -> Tuple[int, ...]:
        """The shape of the whole tensor whose block on a rank has ``shape``."""
        out = list(shape)
        for i in self._cut_dims(dims, len(shape)):
            out[i] *= self.size
        return tuple(out)

    def is_cut(self, dims: Tuple[Optional[str], ...], ndim: int) -> bool:
        """Whether a tensor of ``ndim`` trailing ``dims`` has a block on
        each rank (else every rank holds it whole)."""
        return bool(self._cut_dims(dims, ndim))

    def shape(self, shape: Tuple[int, ...], dims: Tuple[Optional[str], ...]) -> Tuple[int, ...]:
        """The shape of this rank's block of a whole tensor of ``shape``."""
        out = list(shape)
        for i in self._cut_dims(dims, len(shape)):
            if out[i] % self.size:
                raise ValueError(f"dim {dims[len(dims) - len(shape) + i]!r} of {out[i]} does "
                                 f"not split over {self.size} tensor ranks")
            out[i] //= self.size
        return tuple(out)


def tensor_shard(mesh: Optional[Mesh]) -> Optional[TensorShard]:
    """The mesh's ``TensorShard``, or None when its tensor axis has one rank."""
    if mesh is None or mesh.shape["tensor"] == 1:
        return None
    return TensorShard(mesh.index("tensor"), mesh.shape["tensor"])


def shard_params(params, logical_tree, mesh, groups: Optional[Dict[str, int]] = None):
    """This rank's block of every leaf of ``params`` along the dims that
    ``logical_to_spec`` maps to ``tensor`` (the counterpart of JAX's
    ``shard_params``, which places each leaf by its logical dims), each
    cut by ``LeafCuts.take``. ``logical_tree`` mirrors ``params`` with
    tuples of logical dim names; ``groups`` names the fused leaves by tree
    path (``layers/wqkv``) with the number of equal runs their cut dim
    holds. ``mesh`` is a ``Mesh`` or a ``TensorShard``. Each block is a
    copy of its own, so the whole leaf can be freed; with no tensor axis
    the params come back as they are."""
    shard = mesh if isinstance(mesh, TensorShard) else tensor_shard(mesh)
    if shard is None:
        return params
    cuts = LeafCuts(logical_tree, shard, groups)

    def cut(tree, prefix=""):
        out = {}
        for key, value in tree.items():
            path = f"{prefix}{key}"
            if isinstance(value, dict):
                out[key] = cut(value, path + "/")
                continue
            block = cuts.take(path)(value.detach())
            out[key] = block.clone(memory_format=torch.contiguous_format).requires_grad_(
                value.requires_grad)
        return out

    return cut(params)
