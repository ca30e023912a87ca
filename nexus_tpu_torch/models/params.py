"""What the model families share about their parameter dicts: random
initialisation one slice at a time, and the flatten order of the JAX
package's pytrees.

``fill_normal_`` draws a stacked weight one slice of its leading (layer,
expert) dims at a time, in f32 on the generator's device, and writes each
slice scaled into the tensor: the peak over the weights is one slice in
f32, never the whole stack (at Mixtral-8x7B widths the stacked ``w_gate``
alone is 30 GB in f32). ``LeafCuts`` gives a rank of the parameter axes
(``expert`` and ``tensor``; ``fsdp`` too in training) the blocks of its
leaves (parallel/sharding.py).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch


@torch.no_grad()
def fill_normal_(out: torch.Tensor, generator: torch.Generator, scale: float,
                 stack_dims: int = 0, whole: Optional[Tuple[int, ...]] = None,
                 take: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 lead: Optional[Tuple[int, ...]] = None,
                 where: Optional[Callable[[Tuple[int, ...]], Optional[Tuple[int, ...]]]] = None
                 ) -> torch.Tensor:
    """Fill ``out`` with N(0, 1) · ``scale``, drawn slice by slice over its
    first ``stack_dims`` dims. A rank of the parameter axes holds a block of
    the leaf: every slice of the whole leaf (``lead``: its stacked dims) is
    drawn ``whole`` (the slice's shape), ``where`` gives the slice's index
    in ``out`` (None: not this rank's; an expert of another rank) and
    ``take`` keeps the rank's block of it, so the rank's values are the
    one-rank draw's, with the same generator stream."""
    slice_shape = tuple(whole) if whole is not None else tuple(out.shape[stack_dims:])
    lead = tuple(lead) if lead is not None else tuple(out.shape[:stack_dims])
    for idx in itertools.product(*(range(n) for n in lead)):
        x = torch.randn(slice_shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        local = idx if where is None else where(idx)
        if local is None:
            continue
        if take is not None:
            x = take(x)
        out[local].copy_(x.mul_(scale))
    return out


class LeafCuts:
    """A family's leaves as one rank of the parameter axes holds them
    (``shard``, a ``parallel.sharding.ModelShard``): the block shape of each leaf
    (``shape``) and the function that cuts the rank's block out of a whole
    slice of it (``take``), from the family's logical dims and its fused
    leaves' runs (``groups``, by tree path). With no shard every leaf is
    whole."""

    def __init__(self, logical_tree: Dict[str, Any], shard=None,
                 groups: Optional[Dict[str, int]] = None):
        self.dims = dict(tree_items(logical_tree))
        self.shard = shard
        self.groups = groups or {}

    def shape(self, path: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(shape) if self.shard is None else self.shard.shape(shape, self.dims[path])

    def take(self, path: str) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        if self.shard is None:
            return None
        dims, groups = self.dims[path], self.groups.get(path, 1)
        return lambda x: self.shard.take(x, dims, groups)

    def join(self, path: str, blocks) -> torch.Tensor:
        """The whole leaf at ``path`` from every rank's block (in the rank
        order of the shard's axes)."""
        return self.shard.join(blocks, self.dims[path], self.groups.get(path, 1))

    def whole_shape(self, path: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The whole leaf's shape from the shape of a rank's block of it."""
        return tuple(shape) if self.shard is None else self.shard.whole_shape(shape,
                                                                              self.dims[path])

    def is_cut(self, path: str, axis: Optional[str] = None) -> bool:
        """Whether the leaf at ``path`` (a whole stacked leaf) is a block
        on each rank (with ``axis``: a block along that axis); False with
        no shard."""
        dims = self.dims[path]
        return self.shard is not None and self.shard.is_cut(dims, len(dims), axis)

    def copies(self, path: str) -> int:
        """How many ranks of the shard's axes hold the same block of the
        leaf at ``path`` (1 with no shard)."""
        dims = self.dims[path]
        return 1 if self.shard is None else self.shard.copies(dims, len(dims))

    def fill_normal_(self, path: str, out: torch.Tensor, whole: Tuple[int, ...],
                     generator: torch.Generator, scale: float, stack_dims: int = 0) -> None:
        """``fill_normal_`` of the leaf at ``path`` (whole shape ``whole``):
        every slice of the whole leaf drawn, the rank's kept."""
        where = None
        if self.shard is not None:
            dims = self.dims[path]
            where = lambda idx: self.shard.local_index(idx, dims, whole)  # noqa: E731
        fill_normal_(out, generator, scale, stack_dims, whole=tuple(whole)[stack_dims:],
                     take=self.take(path), lead=tuple(whole)[:stack_dims], where=where)


def tree_items(tree: Union[Dict[str, Any], list], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of nested dicts and lists in the JAX pytree flatten
    order: a dict's values by sorted key, a list's by index, at every
    level. A transformer's dict gives ``embed``, ``final_norm``,
    ``layers/<name>`` by name, ``lm_head``; the MLP's list of layers gives
    ``layers/0/b``, ``layers/0/w``, ``layers/1/b``, ..."""
    pairs = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    for key, value in pairs:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            yield from tree_items(value, path + "/")
        else:
            yield path, value


def tree_leaves(tree: Union[Dict[str, Any], list]) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]
