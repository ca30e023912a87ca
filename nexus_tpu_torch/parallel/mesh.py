"""The device mesh over ``torch.distributed`` (counterpart of
``nexus_tpu/parallel/mesh.py``).

JAX builds one ``Mesh`` of devices and lets GSPMD insert the collectives.
Here every rank is a process of a ``torch.distributed`` group, and the mesh
is this rank's coordinate on each of JAX's named axes plus a process group
for each set of axes a collective runs over. Ranks lie on the mesh in
row-major order over ``AXES`` (outer → inner), as JAX reshapes its device
list onto the plan's shape.

The active mesh (``use_mesh``) is what ``ops/ring_attention.py`` reads, as
the JAX op reads the mesh of the enclosing ``with mesh:``.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch.distributed as dist

from nexus_tpu_torch.api.runtime_spec import ParallelismSpec

# Outer → inner. Keep in sync with ParallelismSpec fields.
AXES: Tuple[str, ...] = ("pipeline", "data", "fsdp", "expert", "sequence", "tensor")


@dataclass(frozen=True)
class MeshPlan:
    """A concrete axis-size assignment (product == device count)."""

    pipeline: int = 1
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

    def total(self) -> int:
        return math.prod(self.shape)

    @classmethod
    def from_parallelism(cls, p: ParallelismSpec) -> "MeshPlan":
        return cls(pipeline=p.pipeline, data=p.data, fsdp=p.fsdp, expert=p.expert,
                   sequence=p.sequence, tensor=p.tensor)


def split_dcn_axes(plan_shape: Sequence[int], n_slices: int
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Factor a mesh shape into (ici_shape, dcn_shape) for multislice:
    ``dcn_shape`` absorbs the slice count on the outermost axes possible,
    with ``ici_i * dcn_i == plan_i`` per axis and ``prod(dcn) ==
    n_slices``. Raises if the plan can't split that way."""
    remaining = n_slices
    dcn: List[int] = []
    for size in plan_shape:
        g = math.gcd(size, remaining)
        dcn.append(g)
        remaining //= g
    if remaining != 1:
        raise ValueError(
            f"cannot place {n_slices} slices onto mesh shape {tuple(plan_shape)}: outer axes "
            f"only absorb {n_slices // remaining}; give the data/fsdp/pipeline axes a "
            "multiple of the slice count")
    ici = tuple(s // d for s, d in zip(plan_shape, dcn))
    return ici, tuple(dcn)


def plan_for_devices(n: int, prefer: Sequence[str] = ("fsdp", "tensor", "data"),
                     max_tensor: int = 8) -> MeshPlan:
    """JAX's plan for ``n`` devices when the declared one does not tile
    them: the largest power-of-two divisor of ``n`` up to ``max_tensor`` on
    ``tensor``, the rest on ``fsdp``, then on ``data``."""
    sizes = {a: 1 for a in AXES}
    remaining = n
    if "tensor" in prefer and remaining > 1:
        t = 1
        while t * 2 <= max_tensor and remaining % (t * 2) == 0:
            t *= 2
        sizes["tensor"] = t
        remaining //= t
    if "fsdp" in prefer and remaining > 1:
        sizes["fsdp"] = remaining
        remaining = 1
    if remaining > 1:
        sizes["data"] = remaining
    return MeshPlan(**sizes)


class Mesh:
    """This rank's place on the plan: ``shape`` (axis → size, as JAX's
    ``mesh.shape``), ``index(axis)`` and ``group(*axes)``."""

    def __init__(self, plan: MeshPlan, rank: int = 0):
        self.plan = plan
        self.rank = rank
        self.world = plan.total()
        self.shape: Dict[str, int] = dict(zip(AXES, plan.shape))
        self.coords: Dict[str, int] = self._coords(rank)
        self._groups: Dict[Tuple[str, ...], Optional[object]] = {}

    def _coords(self, rank: int) -> Dict[str, int]:
        coords = {}
        for axis in reversed(AXES):
            coords[axis] = rank % self.shape[axis]
            rank //= self.shape[axis]
        return {a: coords[a] for a in AXES}

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def ranks_along(self, axes: Sequence[str]) -> List[List[int]]:
        """The partition of the world into the groups of ranks that differ
        only on ``axes``; each group in the order of its coordinate on them."""
        fixed = [a for a in AXES if a not in axes]
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(self.world):
            coords = self._coords(r)
            groups.setdefault(tuple(coords[a] for a in fixed), []).append(r)
        return list(groups.values())

    def group(self, *axes: str):
        """The process group of this rank's peers along ``axes``, or None
        when those axes have one rank (nothing to communicate). Made at
        first use with a collective call: every rank asks for the same
        groups in the same order, as every rank runs the same program."""
        key = tuple(a for a in AXES if a in axes)
        if key not in self._groups:
            if self.size(*key) == 1:
                self._groups[key] = None
            elif self.size(*key) == self.world:
                self._groups[key] = dist.group.WORLD
            else:
                mine, _ = dist.new_subgroups_by_enumeration(self.ranks_along(key))
                self._groups[key] = mine
        return self._groups[key]

    def __repr__(self) -> str:
        sized = {a: s for a, s in self.shape.items() if s > 1}
        return f"Mesh({sized or 'one device'}, rank {self.rank} at {self.coords})"


def world_size() -> int:
    """The ranks of the initialised ``torch.distributed`` group, else 1."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def build_mesh(plan: MeshPlan, world: Optional[int] = None) -> Mesh:
    """This rank's mesh over ``world`` ranks (the initialised group's size
    by default, 1 without one). Raises when the plan does not tile them, as
    JAX's ``build_mesh`` does."""
    world = world_size() if world is None else world
    if plan.total() != world:
        raise ValueError(f"mesh plan {plan.shape} (product {plan.total()}) does not tile "
                         f"{world} devices")
    rank = dist.get_rank() if world > 1 else 0
    return Mesh(plan, rank)


# The mesh the model code reads. Process-wide, not thread-local: on the
# card, backward (and a remat block's recompute, which reruns the ring)
# runs on the autograd engine's device thread, which must see it too.
_active: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` the active mesh inside the block (JAX's ``with mesh:``)."""
    global _active
    prev, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = prev


def active_mesh() -> Optional[Mesh]:
    return _active
