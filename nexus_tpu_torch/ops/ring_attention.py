"""Ring attention: exact causal attention over the ``sequence`` mesh axis
(counterpart of ``nexus_tpu/ops/ring_attention.py``).

Each rank holds a (B, S/n, H, D) block of q/k/v, its ``sequence`` index's.
The k/v blocks go round the ring (``parallel/comm.py::ring_shift``, k and
v stacked into one tensor, so every rank runs one chain of shifts in one
order, forward and backward), and each rank folds every visiting block into
its rows: the dense path into an online-softmax state, the flash path
through the K1 kernel and a logsumexp merge of normalised partials, whose
backward runs K2 and K3.

A block a rank cannot see (one from its future) still joins the autograd
graph, with a zero gradient: the shift's backward is a collective, and it
pairs up only if every rank runs it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nexus_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE, _repeat_kv, attention,
                                           flash_attention_lse, tile_ok)
from nexus_tpu_torch.parallel.comm import ring_shift
from nexus_tpu_torch.parallel.mesh import active_mesh


def _online_block(q, k, v, m, l, acc, q_positions, k_positions, causal: bool,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one k/v block (heads already repeated to q's) into the
    (m, l, acc) online-softmax state, (B, H, Q, 1|D) in f32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = k_positions[None, None, None, :] <= q_positions[None, None, :, None]
        if window > 0:
            mask = mask & (k_positions[None, None, None, :]
                           > q_positions[None, None, :, None] - window)
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = alpha * l + p.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * alpha + pv


def _ring_steps(n: int, s_local: int, window: int, causal: bool) -> int:
    """Ring hops needed under a sliding window: the block visiting at step
    s spans [(my-s)·L, (my-s+1)·L), visible to some query row iff its
    newest position reaches the oldest row's window floor, ⟺ s ≤ 1 +
    (window - 2)/L. Exact for window ≥ 2; window 1 sees only the own
    block."""
    if not causal or window <= 0:
        return n
    if window == 1:
        return 1
    return min(n, 2 + (window - 2) // s_local)


class _Unseen(torch.autograd.Function):
    """An unseen block's partial output: f32 zeros of ``shape``, with the
    block as an input whose gradient is zero, which keeps its shift in the
    graph."""

    @staticmethod
    def forward(ctx, kv, shape):
        ctx.kv = (kv.shape, kv.dtype)
        return kv.new_zeros(shape, dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.kv
        return g.new_zeros(shape, dtype=dtype), None


def _merge(out_acc, lse_acc, o_blk, lse_blk):
    """Exact merge of two normalised partials by logsumexp weights. The
    accumulator's lse is finite on every row (the own block holds the
    diagonal), so no -inf - (-inf) is formed."""
    lse_new = torch.logaddexp(lse_acc, lse_blk)
    w_acc = torch.exp(lse_acc - lse_new)[..., None]
    w_blk = torch.exp(lse_blk - lse_new)[..., None]
    return out_acc * w_acc + o_blk * w_blk, lse_new


def ring_attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Ring attention with the flash kernels on each visiting block.

    Step 0 is K1 on the rank's own block (causal). A later block is wholly
    in the past (K1 non-causal; under a window, causal with ``q_offset =
    step·S_local``, where the causal bound is vacuous and the window cuts)
    or wholly in the future (output 0, lse -inf, no launch). The window
    also truncates the ring (``_ring_steps``): blocks older than it are
    never shifted. K/V stay un-repeated under GQA."""
    if window > 0 and not causal:
        raise ValueError("window requires causal ring attention")
    n = torch.distributed.get_world_size(group)
    my_idx = torch.distributed.get_rank(group)
    b, s_local, hq, d = q.shape

    out_acc, lse_acc = flash_attention_lse(q, k, v, causal=causal, window=window)
    out_acc = out_acc.float()
    kv = torch.stack([k, v])
    for step in range(1, _ring_steps(n, s_local, window, causal)):
        kv = ring_shift(kv, group)
        if causal and my_idx < step:  # wrapped round: the block is in the future
            o_blk = _Unseen.apply(kv, (b, s_local, hq, d))
            lse_blk = q.new_full((b, s_local, hq), float("-inf"), dtype=torch.float32)
        else:
            o_blk, lse_blk = flash_attention_lse(
                q, kv[0], kv[1], causal=causal and window > 0,
                q_offset=step * s_local if window > 0 else 0, window=window)
            o_blk = o_blk.float()
        out_acc, lse_acc = _merge(out_acc, lse_acc, o_blk, lse_blk)
    return out_acc.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = True, block_impl: str = "xla",
                   window: int = 0) -> torch.Tensor:
    """Exact attention over sequence blocks, q/k/v (B, S_local, H|Hkv, D)
    of this rank of ``group``. ``block_impl='flash'`` takes
    ``ring_attention_flash``; 'xla' is the dense online-softmax path. In
    both the window truncates the ring."""
    if window > 0 and not causal:
        raise ValueError("window requires causal ring attention")
    if block_impl == "flash":
        return ring_attention_flash(q, k, v, group, causal, window=window)
    n = torch.distributed.get_world_size(group)
    my_idx = torch.distributed.get_rank(group)
    b, s_local, hq, d = q.shape
    n_rep = hq // k.shape[2]
    pos = torch.arange(s_local, device=q.device)
    m = torch.full((b, hq, s_local, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, hq, s_local, 1), device=q.device)
    acc = torch.zeros((b, hq, s_local, d), device=q.device)
    kv = torch.stack([k, v])
    for step in range(_ring_steps(n, s_local, window, causal)):
        if step:
            kv = ring_shift(kv, group)
        src = (my_idx - step) % n  # the rank the held block came from
        m, l, acc = _online_block(q, _repeat_kv(kv[0], n_rep), _repeat_kv(kv[1], n_rep), m, l,
                                  acc, my_idx * s_local + pos, src * s_local + pos, causal,
                                  window=window)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype).transpose(1, 2)


def sequence_offset(s_local: int) -> int:
    """The global position of this rank's first sequence row under the
    active mesh (0 with no sharded ``sequence`` axis)."""
    mesh = active_mesh()
    return 0 if mesh is None else mesh.index("sequence") * s_local


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """Ring attention over the active mesh's ``sequence`` axis, the model
    side's entry: q/k/v are this rank's sequence block. With no sharded
    ``sequence`` axis, plain attention (exact locally), as in JAX. The
    flash blocks run for CUDA tensors whose local block passes ``tile_ok``
    (JAX takes them on a TPU when the local shard tiles), the dense path
    otherwise."""
    mesh = active_mesh()
    if mesh is None or mesh.shape["sequence"] == 1:
        return attention(q, k, v, causal=True, impl=None, window=window)
    block_impl = "flash" if q.is_cuda and tile_ok(q, k) else "xla"
    return ring_attention(q, k, v, mesh.group("sequence"), causal=True,
                          block_impl=block_impl, window=window)
