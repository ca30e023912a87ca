"""Sharding rules (counterpart of ``nexus_tpu/parallel/sharding.py``).

``DEFAULT_LOGICAL_RULES`` and ``logical_to_spec`` are JAX's map of logical
tensor dims onto mesh axes. The port applies them by hand:

* ``batch_spec`` cuts this rank's slice out of the global batch (rows over
  ``data`` and ``fsdp``, columns over ``sequence``);
* ``decode_rows`` gives a rank its rows of a decode batch by JAX's rule
  for the infer cache (rows over the batch axes that tile them),
  ``use_decode_rows`` tells the model's decode that its feeds hold those
  rows, and ``gather_rows`` joins every rank's rows back in row order;
* ``shard_params`` cuts this rank's block out of every parameter along the
  dims the rules put on the model axes, ``expert`` (the MoE stacks' expert
  dim) and ``tensor`` (heads, kv heads, qkv, mlp, vocab), as JAX's
  ``shard_params`` places them (``ModelShard``; ``TensorShard`` for a tensor
  axis alone), and for training on ``fsdp`` too (``embed``:
  ``param_shard``). A fused leaf may cut each of several equal runs of a
  dim in turn (GPT-NeoX's ``wqkv``: q, k and v thirds, each by head).
  ``ModelShard.join`` is the inverse: every rank's block of a leaf back
  into the whole leaf (what a checkpoint holds). The columns of a flat
  heads × head_dim dim are cut whether or not the heads tile the axis
  (JAX's ``qkv`` placement); ``head_span`` gives the whole heads a rank's
  block of them touches. In infer and serve the
  batch axes keep parameters whole on every rank; in training each
  ``fsdp`` rank holds its block of every leaf with an ``embed`` dim, and
  the layers gather them just in time (parallel/fsdp.py).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nexus_tpu_torch.models.params import LeafCuts
from nexus_tpu_torch.parallel.comm import all_gather
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


class HeadSpan(NamedTuple):
    """The whole heads a rank's block of a flat heads × head_dim dim
    touches: heads ``first`` … ``last``, and where the block's first column
    lies inside their columns (``offset``)."""

    first: int
    last: int
    offset: int

    @property
    def heads(self) -> int:
        return self.last - self.first + 1


def head_span(n_heads: int, head_dim: int, rank: int, size: int) -> HeadSpan:
    """The ``HeadSpan`` of block ``rank`` of ``size`` equal blocks of the
    ``n_heads`` × ``head_dim`` columns (``_block``'s cut): 12 heads of 64
    over 8 ranks give rank 1 columns 96…191, heads 1…2, offset 32."""
    cols = _block(n_heads * head_dim, size, rank, "heads x head_dim")
    first = cols.start // head_dim
    return HeadSpan(first, (cols.stop - 1) // head_dim, cols.start - first * head_dim)


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
class DecodeRows:
    """A rank's rows of a decode batch (infer), by JAX's rule for its cache
    layout: the rows lie over ``axes``, (``data``, ``fsdp``) where their
    ranks tile the batch, else ``data`` alone where its ranks do, else none
    (every rank holds every row). This rank holds rows ``start:stop`` of
    ``total``; the ranks of the other axes (``sequence``, and those of the
    batch axes the rows do not lie over) hold the same rows."""

    axes: Tuple[str, ...]
    start: int
    stop: int
    total: int


def decode_rows(mesh: Mesh, batch: int) -> DecodeRows:
    """This rank's ``DecodeRows`` of a ``batch`` of rows on ``mesh``
    (``nexus_tpu/runtime/entrypoints.py``'s ``batch_axes``)."""
    dp, d_only = mesh.size("data", "fsdp"), mesh.shape["data"]
    if dp > 1 and batch % dp == 0:
        axes: Tuple[str, ...] = ("data", "fsdp")
    elif d_only > 1 and batch % d_only == 0:
        axes = ("data",)
    else:
        return DecodeRows((), 0, batch, batch)
    index = 0  # data-major, as JAX lays P(("data", "fsdp")) out
    for a in axes:
        index = index * mesh.shape[a] + mesh.index(a)
    rows = _block(batch, mesh.size(*axes), index, "batch")
    return DecodeRows(tuple(a for a in axes if mesh.shape[a] > 1), rows.start, rows.stop, batch)


# the rows the decode feeds hold while ``use_decode_rows`` is open
_decoding: Optional[DecodeRows] = None


@contextlib.contextmanager
def use_decode_rows(rows: DecodeRows) -> Iterator[DecodeRows]:
    """Make ``rows`` the rows every decode feed holds inside the block (a
    rank's block of an infer batch): what mixes the rows of a feed acts
    over the rows' ranks together, as JAX acts on the whole batch. The
    MoE layer routes the batch's tokens (``ops/moe.py::rows_grid``) and
    the speculative loops run their rounds in step. Process-wide, as the
    active mesh is."""
    global _decoding
    prev, _decoding = _decoding, rows
    try:
        yield rows
    finally:
        _decoding = prev


def split_rows() -> Optional[DecodeRows]:
    """The ``use_decode_rows`` rows when they lie over some axis, else
    None (every rank holds every row, or no block is open)."""
    return _decoding if _decoding is not None and _decoding.axes else None


def gather_rows(x: torch.Tensor, mesh: Mesh, rows: DecodeRows) -> torch.Tensor:
    """Every rank's block of rows of ``x`` (its ``rows`` of a batch, along
    dim 0) joined in row order over the batch axes they lie over: the whole
    batch's on every rank (``x`` itself when every rank holds every row)."""
    if not rows.axes:
        return x
    n = mesh.size(*rows.axes)
    return all_gather(x, mesh.group(*rows.axes)).view(n * x.shape[0], *x.shape[1:])


# the mesh axes that cut parameters, in mesh order (outer → inner): the
# ``embed`` dim over ``fsdp`` (training only), the experts of the MoE
# stacks over ``expert``, heads, d_ff and vocabulary over ``tensor``
PARAM_AXES: Tuple[str, ...] = ("fsdp", "expert", "tensor")
# ...of which infer and serve cut by these (their fsdp ranks hold replicas)
MODEL_AXES: Tuple[str, ...] = PARAM_AXES[1:]


def _runs(a: int, groups: int) -> int:
    """The equal runs of a dim cut by axis ``PARAM_AXES[a]``: a fused
    leaf's ``groups`` on ``tensor``, one on any other axis."""
    return groups if PARAM_AXES[a] == "tensor" else 1


@dataclass(frozen=True)
class ModelShard:
    """This rank's place on the parameter axes: block ``ranks[i]`` of
    ``sizes[i]`` of every dim the rules put on ``PARAM_AXES[i]``. Shorter
    tuples name the inner axes, the outer ones left at one rank
    (``ModelShard((e, t), (ne, nt))``: the model axes alone). A leaf may be
    cut along a dim of each axis (Mixtral's ``w_gate``: its experts over
    ``expert``, its d_model over ``fsdp``, its d_ff over ``tensor``), along
    some, or along none. ``TensorShard(rank, size)`` is the shard of a
    tensor axis alone."""

    ranks: Tuple[int, ...] = (0, 0, 0)
    sizes: Tuple[int, ...] = (1, 1, 1)

    def __post_init__(self):
        pad = len(PARAM_AXES) - len(self.ranks)
        object.__setattr__(self, "ranks", (0,) * pad + tuple(self.ranks))
        object.__setattr__(self, "sizes", (1,) * pad + tuple(self.sizes))

    def on(self, axis: str) -> Tuple[int, int]:
        """(rank, size) on ``axis``."""
        i = PARAM_AXES.index(axis)
        return self.ranks[i], self.sizes[i]

    @property
    def tensor(self) -> Tuple[int, int]:
        """(rank, size) on the tensor axis."""
        return self.on("tensor")

    @property
    def expert(self) -> Tuple[int, int]:
        """(rank, size) on the expert axis."""
        return self.on("expert")

    def _cut_dims(self, dims: Tuple[Optional[str], ...], ndim: int) -> Dict[int, int]:
        """{axis index in ``PARAM_AXES``: position among the ``ndim`` trailing
        dims of ``dims``} of each dim ``logical_to_spec`` puts on an axis of
        more than one rank."""
        out: Dict[int, int] = {}
        for i, axis in enumerate(logical_to_spec(tuple(dims)[len(dims) - ndim:])):
            if axis in PARAM_AXES and self.sizes[PARAM_AXES.index(axis)] > 1:
                a = PARAM_AXES.index(axis)
                if a in out:
                    raise ValueError(f"dims {dims} put two dims on {axis}: a rank's blocks do "
                                     "not tile such a tensor")
                out[a] = i
        return out

    def _what(self, dims, ndim: int, i: int) -> str:
        return repr(tuple(dims)[len(dims) - ndim + i])

    def take(self, x: torch.Tensor, dims: Tuple[Optional[str], ...],
             groups: int = 1) -> torch.Tensor:
        """This rank's block of ``x``, a whole tensor whose dims are the
        trailing ones of ``dims`` (a stacked leaf or a slice of it): along
        each cut dim the rank keeps its block; a dim on ``tensor`` is read as
        ``groups`` equal runs, and the rank keeps its block of each run, in
        order."""
        for a, i in self._cut_dims(dims, x.dim()).items():
            runs, size, n = _runs(a, groups), self.sizes[a], x.shape[i]
            if n % (runs * size):
                raise ValueError(f"dim {self._what(dims, x.dim(), i)} of {n} does not split "
                                 f"into {runs} run(s) over {size} {PARAM_AXES[a]} ranks")
            x = x.unflatten(i, (runs, size, n // (runs * size)))
            x = x.select(i + 1, self.ranks[a]).flatten(i, i + 1)
        return x

    def join(self, blocks: Sequence[torch.Tensor], dims: Tuple[Optional[str], ...],
             groups: int = 1) -> torch.Tensor:
        """The whole tensor from every rank's block: ``blocks`` in the rank
        order of the axes' group (row-major over ``PARAM_AXES``: fsdp-major, then
        expert, then tensor), one per rank; the inverse of ``take``, fused
        runs included. Ranks that differ only on an axis that does not cut
        the tensor hold the same block: the first of them is used."""
        if len(blocks) != math.prod(self.sizes):
            raise ValueError(f"{len(blocks)} blocks for {math.prod(self.sizes)} ranks of "
                             f"the axes {PARAM_AXES}")
        cut = self._cut_dims(dims, blocks[0].dim())

        def joined(parts, a):
            if a not in cut:
                return parts[0]
            i, n, runs = cut[a], parts[0].shape[cut[a]], _runs(a, groups)
            if n % runs:
                raise ValueError(f"dim {self._what(dims, parts[0].dim(), i)} of {n} does not "
                                 f"split into {runs} run(s)")
            stacked = torch.stack([b.unflatten(i, (runs, n // runs)) for b in parts], dim=i + 1)
            return stacked.flatten(i, i + 2)

        level = list(blocks)
        for a in reversed(range(len(PARAM_AXES))):  # the innermost axis first
            size = self.sizes[a]
            level = [joined(level[j:j + size], a) for j in range(0, len(level), size)]
        return level[0]

    def whole_shape(self, shape: Tuple[int, ...], dims: Tuple[Optional[str], ...]
                    ) -> Tuple[int, ...]:
        """The shape of the whole tensor whose block on a rank has ``shape``."""
        out = list(shape)
        for a, i in self._cut_dims(dims, len(shape)).items():
            out[i] *= self.sizes[a]
        return tuple(out)

    def is_cut(self, dims: Tuple[Optional[str], ...], ndim: int,
               axis: Optional[str] = None) -> bool:
        """Whether a tensor of ``ndim`` trailing ``dims`` has a block on
        each rank (else every rank holds it whole); with ``axis``, whether
        that axis cuts it."""
        cut = self._cut_dims(dims, ndim)
        if axis is None:
            return bool(cut)
        return PARAM_AXES.index(axis) in cut

    def copies(self, dims: Tuple[Optional[str], ...], ndim: int) -> int:
        """How many ranks of the axes hold the same block of such a
        tensor: the product of the sizes of the axes that do not cut it."""
        cut = self._cut_dims(dims, ndim)
        return math.prod(n for a, n in enumerate(self.sizes) if a not in cut)

    def shape(self, shape: Tuple[int, ...], dims: Tuple[Optional[str], ...]) -> Tuple[int, ...]:
        """The shape of this rank's block of a whole tensor of ``shape``."""
        out = list(shape)
        for a, i in self._cut_dims(dims, len(shape)).items():
            if out[i] % self.sizes[a]:
                raise ValueError(f"dim {self._what(dims, len(shape), i)} of {out[i]} does not "
                                 f"split over {self.sizes[a]} {PARAM_AXES[a]} ranks")
            out[i] //= self.sizes[a]
        return tuple(out)

    def local_index(self, idx: Tuple[int, ...], dims: Tuple[Optional[str], ...],
                    shape: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
        """Where the slice at ``idx`` of the leading dims of a whole tensor
        of ``shape`` lies in this rank's block, or None when its block does
        not hold it (a leading dim cut: the MoE stacks' expert dim)."""
        cut = {i: a for a, i in self._cut_dims(dims, len(shape)).items()}
        out = []
        for i, j in enumerate(idx):
            if i in cut:
                a = cut[i]
                n = shape[i] // self.sizes[a]
                j -= self.ranks[a] * n
                if not 0 <= j < n:
                    return None
            out.append(j)
        return tuple(out)

    def experts(self, n_experts: int) -> range:
        """The experts whose weights this rank holds."""
        rank, size = self.expert
        return range(rank * n_experts // size, (rank + 1) * n_experts // size)


def TensorShard(rank: int, size: int) -> ModelShard:  # noqa: N802 (a shard's constructor)
    """This rank's place on a ``tensor`` axis alone: block ``rank`` of
    ``size`` of every dim the rules put on it."""
    return ModelShard((0, rank), (1, size))


def _shard(mesh: Optional[Mesh], axes: Tuple[str, ...]) -> Optional[ModelShard]:
    """The mesh's shard over ``axes`` (the others held at one rank), or
    None when they all have one rank."""
    if mesh is None or mesh.size(*axes) == 1:
        return None
    return ModelShard(tuple(mesh.index(a) if a in axes else 0 for a in PARAM_AXES),
                      tuple(mesh.shape[a] if a in axes else 1 for a in PARAM_AXES))


def model_shard(mesh: Optional[Mesh]) -> Optional[ModelShard]:
    """The mesh's shard over its model axes (``expert`` and ``tensor``, fsdp
    at one rank), or None when both have one rank: what infer and serve cut
    by (their ``fsdp`` ranks hold whole replicas)."""
    return _shard(mesh, MODEL_AXES)


def param_shard(mesh: Optional[Mesh]) -> Optional[ModelShard]:
    """The mesh's shard over ``PARAM_AXES`` (``fsdp``, ``expert`` and
    ``tensor``), or None when all three have one rank: what training cuts
    by. A leaf's ``embed`` dim lies over ``fsdp`` (parallel/fsdp.py gathers
    it in the layer that uses it)."""
    return _shard(mesh, PARAM_AXES)


def shard_params(params, logical_tree, mesh, groups: Optional[Dict[str, int]] = None):
    """This rank's block of every leaf of ``params`` along the dims that
    ``logical_to_spec`` maps to an axis of the shard (the counterpart of JAX's
    ``shard_params``, which places each leaf by its logical dims), each
    cut by ``LeafCuts.take``. ``logical_tree`` mirrors ``params`` with
    tuples of logical dim names; ``groups`` names the fused leaves by tree
    path (``layers/wqkv``) with the number of equal runs their cut dim
    holds. ``mesh`` is a ``ModelShard`` (``param_shard``'s for training)
    or a ``Mesh`` (its ``model_shard``). Each block is a copy of its
    own, so the whole leaf can be freed; with no cut the params come back
    as they are."""
    shard = mesh if isinstance(mesh, ModelShard) else model_shard(mesh)
    if shard is None:
        return params
    cuts = LeafCuts(logical_tree, shard, groups)

    def cut(tree, prefix=""):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, value in items:
            path = f"{prefix}{key}"
            if isinstance(value, (dict, list)):
                out[key] = cut(value, path + "/")
                continue
            block = cuts.take(path)(value.detach())
            out[key] = block.clone(memory_format=torch.contiguous_format).requires_grad_(
                value.requires_grad)
        return out if isinstance(tree, dict) else [out[i] for i in range(len(tree))]

    return cut(params)
