"""Mixture-of-Experts routing and dispatch (counterpart of
``nexus_tpu/ops/moe.py``).

Capacity-based top-k routing in the Switch style with JAX's exact rules:
softmax in f32, renormalised top-k weights, the Switch load-balance loss,
capacity slots by a token-major running count over the (T·k, E)
selections, and the dropped fraction from the index form. Two dispatches
compute the same numbers: the dense one (three contractions over the
(T, E, C) dispatch / combine tensors) and the scatter one (each selected
token moved into its (expert, slot) and gathered back).

Two deliberate differences from the JAX module: ties among equal router
probabilities go to the lower expert index by an explicit stable sort
(``lax.top_k``'s order; ``torch.topk`` promises none), and the dense
(T, E, C) tensors are built only when asked for (``dense=True``): eager
PyTorch has no dead-code elimination to drop them from the scatter path.

Over ranks (module item 4c): ``global_top_k_routing`` routes a rank's
tokens as JAX routes the global batch under GSPMD (capacity, slots, drops
and the aux loss over the global token population, from an all-gather of
the small (T, k) expert indices over the batch axes), and
``expert_block`` gives the routing as a rank that holds a block of the
experts (the ``expert`` axis) acts on it: its dispatch and combine cover
its own experts only, and the model sums the ranks' partial outputs.
Capacity is the global one, but a rank with batch peers holds its own
tokens' selections only: ``own_slots`` numbers them densely, so that its
expert buffers are (E_local, C_local, D), C_local the most any of its
experts keeps, and not the (E_local, C_global, D) only its share fills (a
deliberate difference: JAX's GSPMD buffers are global). ``rows_grid`` is
the grid of an infer decode whose rows lie over the batch axes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from nexus_tpu_torch.parallel.comm import all_gather
from nexus_tpu_torch.parallel.mesh import Mesh


class RoutingResult(NamedTuple):
    combine: Optional[torch.Tensor]  # (T, E, C) f32 combine weights (dense=True only)
    dispatch: Optional[torch.Tensor]  # (T, E, C) f32 1/0 dispatch mask (dense=True only)
    aux_loss: torch.Tensor  # scalar load-balancing loss
    router_probs: torch.Tensor  # (T, E) f32
    dropped_fraction: torch.Tensor  # scalar: selections lost to capacity
    # index form of the same assignment (the scatter/gather path):
    expert_index: torch.Tensor  # (T, k) int32 chosen expert per selection
    slot_index: torch.Tensor  # (T, k) int32 capacity slot (clamped)
    valid: torch.Tensor  # (T, k) f32 1/0: the selection survived capacity
    weights: torch.Tensor  # (T, k) f32 renormalised combine weights


def _top_k(probs: torch.Tensor, num_selected: int):
    """(top_idx, renormalised top_probs) of (T, E) probabilities; descending
    and stable: equal probabilities keep the lower index first."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    top_idx = order[:, :num_selected]  # (T, k)
    top_probs = torch.gather(probs, 1, top_idx)
    return top_idx, top_probs / top_probs.sum(-1, keepdim=True)


def _slots(top_idx: torch.Tensor, e: int, capacity: int):
    """(slot_idx, valid, sel_mask) of (T, k) selections: the position of
    each (token, choice) in its expert's buffer, a running count over the
    token-major (T*k, E) selections (exact in integers); past ``capacity``
    a selection is dropped (valid 0) and its slot clamped."""
    t, k = top_idx.shape
    sel_mask = F.one_hot(top_idx.long(), e).float()  # (T, k, E)
    flat_mask = sel_mask.reshape(t * k, e).to(torch.int32)
    positions = (torch.cumsum(flat_mask, 0, dtype=torch.int32) * flat_mask - 1)
    positions = positions.reshape(t, k, e)
    in_capacity = (positions >= 0) & (positions < capacity)
    sel = sel_mask.to(torch.int32)
    slot_idx = (positions.clamp(0, capacity - 1) * sel).sum(-1, dtype=torch.int32)
    valid = (in_capacity.float() * sel_mask).sum(-1)
    return slot_idx, valid, sel_mask


def _dense(top_idx: torch.Tensor, slot_idx: torch.Tensor, valid: torch.Tensor,
           weights: torch.Tensor, e: int, capacity: int):
    """The (T, E, C) dispatch mask and combine weights of the index form."""
    t, k = top_idx.shape
    rows = torch.arange(t, device=top_idx.device)[:, None].expand(t, k)
    where = (rows.reshape(-1), top_idx.reshape(-1).long(), slot_idx.reshape(-1).long())
    zeros = torch.zeros((t, e, capacity), dtype=torch.float32, device=top_idx.device)
    # each (token, expert) pair holds at most one selection: the sums
    # below take one term, as JAX's sums over k do
    dispatch = zeros.index_put(where, valid.reshape(-1), accumulate=True)
    combine = zeros.index_put(where, (weights * valid).reshape(-1), accumulate=True)
    return dispatch, combine


def top_k_routing(router_logits: torch.Tensor, num_selected: int, capacity: int,
                  dense: bool = True) -> RoutingResult:
    """Top-k token → expert assignment with per-expert capacity.

    ``router_logits``: (T, E). A selection past its expert's capacity is
    dropped (its ``valid`` is 0). ``dense``: also build the (T, E, C)
    dispatch and combine tensors (the einsum dispatch reads them)."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)  # (T, E)
    top_idx, top_probs = _top_k(probs, num_selected)
    slot_idx, valid, sel_mask = _slots(top_idx, e, capacity)
    # Switch aux loss: E * sum_e (fraction of tokens routed to e) * (mean prob e)
    aux_loss = e * torch.sum(sel_mask.sum(1).mean(0) * probs.mean(0))
    dropped = torch.clamp(1.0 - valid.sum() / (t * num_selected), min=0.0)
    dispatch = combine = None
    if dense:
        dispatch, combine = _dense(top_idx, slot_idx, valid, top_probs, e, capacity)
    return RoutingResult(combine, dispatch, aux_loss, probs, dropped, top_idx.to(torch.int32),
                         slot_idx, valid, top_probs)


@dataclass(frozen=True)
class TokenGrid:
    """Where a rank's (b, s) tokens lie in the global (B, S) batch: row
    block ``row`` of ``rows`` (the ``data`` × ``fsdp`` ranks, data outer,
    as ``parallel/sharding.py::batch_spec`` cuts them) and column block
    ``col`` of ``cols`` (the ``sequence`` ranks); ``group`` holds those
    ranks, in its rank order data-major, then fsdp, then sequence."""

    group: Any
    rows: int
    cols: int
    row: int
    col: int

    @property
    def ranks(self) -> int:
        return self.rows * self.cols


def token_grid(mesh: Optional[Mesh]) -> Optional[TokenGrid]:
    """The mesh's ``TokenGrid``, or None when its batch axes (``data``,
    ``fsdp``, ``sequence``) have one rank: every token is this rank's."""
    if mesh is None or mesh.size("data", "fsdp", "sequence") == 1:
        return None
    return TokenGrid(mesh.group("data", "fsdp", "sequence"), mesh.size("data", "fsdp"),
                     mesh.shape["sequence"],
                     mesh.index("data") * mesh.shape["fsdp"] + mesh.index("fsdp"),
                     mesh.index("sequence"))


def rows_grid(mesh: Optional[Mesh], rows) -> Optional[TokenGrid]:
    """The ``TokenGrid`` of a decode feed that holds this rank's block of
    a batch's rows (``rows``, a ``parallel/sharding.py::DecodeRows``):
    the ranks of ``rows.axes`` hold the row blocks, data-major, each the
    whole feed's width (one column). None when every rank holds every
    row (no ``rows``, or none of its axes has two ranks)."""
    if mesh is None or rows is None or not rows.axes:
        return None
    index = 0
    for a in rows.axes:
        index = index * mesh.shape[a] + mesh.index(a)
    return TokenGrid(mesh.group(*rows.axes), mesh.size(*rows.axes), 1, index, 0)


def global_top_k_routing(router_logits: torch.Tensor, num_selected: int, capacity: int,
                         batch_shape: Tuple[int, int], grid: TokenGrid) -> RoutingResult:
    """``top_k_routing`` of the global token population, on one rank of a
    ``grid`` whose ranks hold the batch's (b, s) blocks (``batch_shape``):
    what JAX's ``top_k_routing`` computes on the global (B·S, E) logits
    under GSPMD, for this rank's rows. ``capacity`` is the global one
    (``default_capacity`` of the global token count).

    The rank's (T, k) int32 expert indices are all-gathered over the grid
    (never the (T, E) probabilities) and put into the global token order:
    rows data-major, and under ``sequence`` each row's column blocks side
    by side, so a rank's tokens are not one run of that order. Slots come
    from the running count over all T·k selections of that order, as in
    JAX; this rank keeps the ``slot_index`` and ``valid`` of its own rows.
    The dropped fraction counts the global selections.

    The aux loss is E · Σ_e f_e · P_e with ``f_e`` the global share of
    selections of expert e (from indices: no gradient) and ``P_e`` the
    rank's own mean probability. Every rank holds as many tokens, so the
    mean over the grid's ranks of this local aux loss is JAX's global one,
    and the mean of their gradients (what the trainer takes over the batch
    axes) is its gradient. The dense (T, E, C) tensors are not built here
    (``expert_block`` builds those of a rank's experts)."""
    t, e = router_logits.shape
    b, s = batch_shape
    k = num_selected
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_idx, top_probs = _top_k(probs, k)
    gathered = all_gather(top_idx.to(torch.int32).contiguous(), grid.group)
    order = gathered.view(grid.rows, grid.cols, b, s, k).permute(0, 2, 1, 3, 4).reshape(-1, k)
    slot_idx, valid, sel_mask = _slots(order, e, capacity)
    aux_loss = e * torch.sum(sel_mask.sum(1).mean(0) * probs.mean(0))
    dropped = torch.clamp(1.0 - valid.sum() / valid.numel(), min=0.0)

    def mine(x):
        return x.view(grid.rows, b, grid.cols, s, k)[grid.row, :, grid.col].reshape(t, k)

    return RoutingResult(None, None, aux_loss, probs, dropped, top_idx.to(torch.int32),
                         mine(slot_idx), mine(valid), top_probs)


def expert_block(routing: RoutingResult, first: int, count: int, capacity: int,
                 dense: bool = False) -> RoutingResult:
    """``routing`` as a rank holding experts [first, first + count) acts
    on it: ``expert_index`` counted from the block's first expert, the
    selections of other experts' invalid (``valid`` 0, pointed at a
    clamped slot of the block, to which they add zeros), and with
    ``dense`` the (T, count, C) dispatch and combine tensors of the block.
    The whole set of experts (first 0, count E) is ``routing`` itself,
    dense tensors built when asked."""
    idx = routing.expert_index.long() - first
    mine = (idx >= 0) & (idx < count)
    valid = routing.valid * mine
    idx = idx.clamp(0, count - 1).to(torch.int32)
    dispatch = combine = None
    if dense:
        dispatch, combine = _dense(idx, routing.slot_index, valid, routing.weights, count,
                                   capacity)
    return routing._replace(combine=combine, dispatch=dispatch, expert_index=idx, valid=valid)


def own_slots(routing: RoutingResult, count: int,
              dense: bool = False) -> Tuple[RoutingResult, int]:
    """(``routing``, capacity) for buffers that hold this rank's own
    selections only: ``routing`` is a rank's ``expert_block`` of a global
    routing over ``count`` experts, and each valid selection's slot is
    renumbered densely among its expert's valid selections, in token
    order (the order of their global slots). The capacity is C_local, the
    most valid selections any of the ``count`` experts holds (at least
    1), read on the host. Valid flags, weights, the aux loss and the
    dropped fraction stay the global routing's: only where a kept
    selection lies in its expert's buffer moves, and the expert FFN acts
    on each row alone. An invalid selection points at slot 0, to which it
    adds zeros. With ``dense``, the (T, count, C_local) dispatch and
    combine tensors too."""
    t, k = routing.expert_index.shape
    mask = (F.one_hot(routing.expert_index.long(), count).to(torch.int32)
            * routing.valid.to(torch.int32)[..., None]).reshape(t * k, count)
    counts = torch.cumsum(mask, 0, dtype=torch.int32)
    capacity = max(int(counts[-1].max()), 1) if t * k else 1
    slots = ((counts - 1).clamp(min=0) * mask).sum(-1, dtype=torch.int32).reshape(t, k)
    dispatch = combine = None
    if dense:
        dispatch, combine = _dense(routing.expert_index, slots, routing.valid, routing.weights,
                                   count, capacity)
    return routing._replace(slot_index=slots, dispatch=dispatch, combine=combine), capacity


def moe_dispatch_dense(x: torch.Tensor, routing: RoutingResult) -> torch.Tensor:
    """Token → expert buffers: (T, D) × (T, E, C) → (E, C, D) f32 (JAX
    promotes the bf16 tokens to the f32 mask's type)."""
    return torch.einsum("td,tec->ecd", x.float(), routing.dispatch)


def moe_combine_dense(expert_out: torch.Tensor, routing: RoutingResult) -> torch.Tensor:
    """Expert buffers → tokens: (E, C, D) × (T, E, C) → (T, D)."""
    return torch.einsum("ecd,tec->td", expert_out, routing.combine.to(expert_out.dtype))


def _flat_slots(routing: RoutingResult, capacity: int) -> torch.Tensor:
    return (routing.expert_index.long() * capacity + routing.slot_index.long()).reshape(-1)


def moe_dispatch_scatter(x: torch.Tensor, routing: RoutingResult, num_experts: int,
                         capacity: int) -> torch.Tensor:
    """Token → expert buffers by moving each selected token into its
    (expert, slot): O(T·k·D) data movement. A slot receives at most one
    surviving selection; a dropped one adds zeros to its clamped slot."""
    t, k = routing.expert_index.shape
    d = x.shape[-1]
    contrib = (x[:, None, :] * routing.valid[..., None].to(x.dtype)).reshape(t * k, d)
    buf = torch.zeros((num_experts * capacity, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, _flat_slots(routing, capacity), contrib)
    return buf.reshape(num_experts, capacity, d)


def moe_combine_scatter(expert_out: torch.Tensor, routing: RoutingResult) -> torch.Tensor:
    """Expert buffers → tokens: gather each selection's slot and sum the k
    of them, weighted, in f32 (inverse of ``moe_dispatch_scatter``)."""
    e, c, d = expert_out.shape
    t, k = routing.expert_index.shape
    gathered = expert_out.reshape(e * c, d)[_flat_slots(routing, c)].reshape(t, k, d).float()
    w = (routing.weights * routing.valid)[..., None]
    return (gathered * w).sum(1).to(expert_out.dtype)


def default_capacity(tokens: int, num_experts: int, num_selected: int,
                     capacity_factor: float = 1.25) -> int:
    cap = int(tokens * num_selected * capacity_factor / num_experts)
    return max(cap, num_selected)
