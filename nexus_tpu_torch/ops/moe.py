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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


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


def top_k_routing(router_logits: torch.Tensor, num_selected: int, capacity: int,
                  dense: bool = True) -> RoutingResult:
    """Top-k token → expert assignment with per-expert capacity.

    ``router_logits``: (T, E). A selection past its expert's capacity is
    dropped (its ``valid`` is 0). ``dense``: also build the (T, E, C)
    dispatch and combine tensors (the einsum dispatch reads them)."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)  # (T, E)
    # descending and stable: equal probabilities keep the lower index first
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    top_idx = order[:, :num_selected]  # (T, k)
    top_probs = torch.gather(probs, 1, top_idx)
    top_probs = top_probs / top_probs.sum(-1, keepdim=True)

    # Switch aux loss: E * sum_e (fraction of tokens routed to e) * (mean prob e)
    sel_mask = F.one_hot(top_idx, e).float()  # (T, k, E)
    tokens_per_expert = sel_mask.sum(1).mean(0)
    aux_loss = e * torch.sum(tokens_per_expert * probs.mean(0))

    # position of each (token, choice) in its expert's buffer: a running
    # count over the token-major (T*k, E) selections (exact in integers)
    flat_mask = sel_mask.reshape(t * num_selected, e).to(torch.int32)
    positions = (torch.cumsum(flat_mask, 0, dtype=torch.int32) * flat_mask - 1)
    positions = positions.reshape(t, num_selected, e)
    in_capacity = (positions >= 0) & (positions < capacity)
    pos_clamped = positions.clamp(0, capacity - 1)
    sel = sel_mask.to(torch.int32)
    slot_idx = (pos_clamped * sel).sum(-1, dtype=torch.int32)
    valid = (in_capacity.float() * sel_mask).sum(-1)
    dropped = torch.clamp(1.0 - valid.sum() / (t * num_selected), min=0.0)

    dispatch = combine = None
    if dense:
        rows = torch.arange(t, device=probs.device)[:, None].expand(t, num_selected)
        where = (rows.reshape(-1), top_idx.reshape(-1), slot_idx.reshape(-1).long())
        zeros = torch.zeros((t, e, capacity), dtype=torch.float32, device=probs.device)
        # each (token, expert) pair holds at most one selection: the sums
        # below take one term, as JAX's sums over k do
        dispatch = zeros.index_put(where, valid.reshape(-1), accumulate=True)
        combine = zeros.index_put(where, (top_probs * valid).reshape(-1), accumulate=True)
    return RoutingResult(combine, dispatch, aux_loss, probs, dropped, top_idx.to(torch.int32),
                         slot_idx, valid, top_probs)


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
