"""Parameters sharded over the ``fsdp`` axis in training (the counterpart of
the ZeRO-3 layout GSPMD gives JAX's params: ``DEFAULT_LOGICAL_RULES`` put
``embed`` on ``fsdp``, and XLA gathers a layer's weights just in time and
reduce-scatters their gradients).

A training rank holds its block of every leaf whose logical dims include
``embed``, cut along that dim (``parallel/sharding.py::param_shard``).
``gather`` turns a layer's blocks into its whole weights where the layer
runs: one all-gather a dtype over the fsdp group, the blocks joined in
rank order along each leaf's ``embed`` dim. It is a
``torch.autograd.Function``; its backward reduce-scatters each whole
gradient back to the rank's block, summed over the fsdp ranks (one
collective a dtype). Leaves with no ``embed`` dim (the norms, GPT-NeoX's
and the MLP's biases) pass through whole.

Nothing keeps a gathered weight from forward to backward: under
``saved_as_blocks`` (the trainer's step) a tensor the autograd graph saves
that lies in a gathered weight's storage is packed as the block it came
from, and gathered again when the backward unpacks it. A block that
``torch.utils.checkpoint`` wraps saves through the checkpoint's own hooks,
which nest inside these and win there: the recompute replays the gather
(ops/remat.py).

The models find the group from their weights' shapes, as they find the
tensor axis's: ``fsdp_group`` reads how much of the ``embed`` dim a leaf
holds. Params whole over ``fsdp`` (infer, serve, one rank) gather nothing.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nexus_tpu_torch.parallel.comm import all_gather, by_dtype, reduce_scatter
from nexus_tpu_torch.parallel.mesh import active_mesh


def embed_dims(logical: Dict[str, Tuple[Optional[str], ...]],
               keys: Sequence[str]) -> List[Optional[int]]:
    """The position of ``embed`` in one layer's slice of each stacked leaf
    ``keys`` names (its ``layer`` dim dropped), None for a leaf without
    it."""
    out: List[Optional[int]] = []
    for k in keys:
        dims = tuple(logical[k])[1:]
        out.append(dims.index("embed") if "embed" in dims else None)
    return out


def fsdp_group(whole: int, held: int):
    """The fsdp group the params were cut for: a leaf's ``embed`` dim of
    ``whole`` elements of which the rank holds ``held``. None for whole
    params; raises when the active mesh's fsdp axis is not that many ranks."""
    degree = whole // held
    if degree == 1:
        return None
    mesh = active_mesh()
    have = 1 if mesh is None else mesh.shape["fsdp"]
    if have != degree:
        raise ValueError(f"the weights are cut for {degree} fsdp ranks but the active mesh has "
                         f"{have} (run inside parallel.mesh.use_mesh of the mesh they were "
                         "sharded for)")
    return mesh.group("fsdp")


def embed_group(params: Dict[str, Any], cfg: Any):
    """A transformer's fsdp group (``fsdp_group``), read from ``embed``'s
    columns against ``cfg.d_model``; None for params whole over fsdp."""
    return fsdp_group(cfg.d_model, params["embed"].shape[-1])


def gather_blocks(blocks: Sequence[torch.Tensor], dims: Sequence[int],
                  group) -> List[torch.Tensor]:
    """The whole tensors from every fsdp rank's ``blocks``, each joined
    along its ``dims`` entry in rank order: one all-gather a dtype over the
    blocks laid end to end. Each whole is an allocation of its own."""
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = [None] * len(blocks)  # type: ignore[list-item]
    for idx in by_dtype(blocks):
        flat = all_gather(torch.cat([blocks[i].detach().reshape(-1) for i in idx]), group)
        # row r: rank r's blocks of these leaves, side by side
        rows = flat.view(n, -1)
        for i, cols in zip(idx, rows.split([blocks[i].numel() for i in idx], dim=1)):
            parts = [c.view(blocks[i].shape) for c in cols.unbind(0)]
            out[i] = torch.cat(parts, dim=dims[i])
    return out


def reduce_blocks(grads: Sequence[torch.Tensor], dims: Sequence[int],
                  group) -> List[torch.Tensor]:
    """This rank's block of the sum over the fsdp ranks of each whole
    gradient in ``grads``, cut along its ``dims`` entry: one reduce-scatter
    a dtype over the gradients laid out so that each rank's blocks lie
    together."""
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = [None] * len(grads)  # type: ignore[list-item]
    for idx in by_dtype(grads):
        chunks = [torch.stack(grads[i].chunk(n, dims[i])) for i in idx]
        block = reduce_scatter(torch.cat([c.reshape(n, -1) for c in chunks], dim=1), group)
        for i, c, b in zip(idx, chunks, block.split([c[0].numel() for c in chunks])):
            out[i] = b.view(c.shape[1:])
    return out


# storage address → (block, dim, group) of every live gathered weight;
# each entry leaves with its weight
_gathered: Dict[int, Tuple[torch.Tensor, int, Any]] = {}


def _register(whole: torch.Tensor, block: torch.Tensor, dim: int, group) -> None:
    key = whole.untyped_storage().data_ptr()
    _gathered[key] = (block.detach(), dim, group)
    weakref.finalize(whole, _gathered.pop, key, None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dims, *blocks):
        ctx.group, ctx.dims = group, dims
        ctx.blocks = [(b.shape, b.dtype, b.device) for b in blocks]
        wholes = gather_blocks(blocks, dims, group)
        for whole, block, dim in zip(wholes, blocks, dims):
            _register(whole, block, dim, group)
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        n = dist.get_world_size(ctx.group)
        full = []
        for g, (shape, dtype, device), dim in zip(grads, ctx.blocks, ctx.dims):
            if g is None:  # a weight the loss did not reach: the same on every rank
                whole = list(shape)
                whole[dim] *= n
                g = torch.zeros(whole, dtype=dtype, device=device)
            full.append(g)
        return (None, None, *reduce_blocks(full, ctx.dims, ctx.group))


def gather(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
           group) -> List[torch.Tensor]:
    """``tensors`` (a layer's leaves as this rank holds them) with each
    block whose ``dims`` entry is a dim gathered whole along it over the
    fsdp ``group``; a leaf whose entry is None passes as it is, and so does
    every leaf without a group (whole params). Differentiable: the whole
    gradients are reduce-scattered back to the blocks (module doc)."""
    if group is None:
        return list(tensors)
    at = [i for i, d in enumerate(dims) if d is not None]
    if not at:
        return list(tensors)
    wholes = _Gather.apply(group, tuple(dims[i] for i in at), *(tensors[i] for i in at))
    out = list(tensors)
    for i, w in zip(at, wholes):
        out[i] = w
    return out


def gather_one(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``gather`` of one leaf: ``embed`` or ``lm_head`` where it is used."""
    return gather([t], [dim], group)[0]


def lm_head(params: Dict[str, Any], cfg: Any) -> torch.Tensor:
    """A transformer's ``lm_head`` (its ``embed`` dim first), gathered whole
    over fsdp where it is cut."""
    return gather_one(params["lm_head"], 0, embed_group(params, cfg))


@dataclass
class _Packed:
    """A saved tensor that lies in a gathered weight: the block, dim and
    group to gather the weight again, and the tensor's place in it."""

    source: Tuple[torch.Tensor, int, Any]
    size: torch.Size
    stride: Tuple[int, ...]
    offset: int


def _pack(x: torch.Tensor):
    # what the graph keeps holds no reference to ``x`` itself: a saved
    # output would hold its own node, a cycle no collector frees
    if not _gathered or x.is_sparse or x.device.type == "meta":
        return x.detach()
    source = _gathered.get(x.untyped_storage().data_ptr())
    if source is None or x.dtype != source[0].dtype:
        return x.detach()
    return _Packed(source, x.size(), x.stride(), x.storage_offset())


def _unpack(p):
    if not isinstance(p, _Packed):
        return p
    block, dim, group = p.source
    whole = gather_blocks([block], [dim], group)[0]
    return whole.as_strided(p.size, p.stride, p.offset)


@contextlib.contextmanager
def saved_as_blocks() -> Iterator[None]:
    """Inside the block, a gathered weight the autograd graph saves is
    kept as its block and gathered again in the backward (module doc):
    the peak holds one layer's whole weights, never every layer's."""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield
