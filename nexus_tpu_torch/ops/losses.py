"""Next-token cross entropy (counterpart of ``nexus_tpu/ops/losses.py``).

``dense_softmax_xent`` materialises the (B, S, V) f32 logits.
``chunked_softmax_xent`` computes the same mean NLL over vocab chunks with an
online logsumexp; each chunk runs under ``torch.utils.checkpoint``, so the
backward recomputes the chunk's logits instead of saving them and peak
logits memory is O(B·S·chunk) instead of O(B·S·V).

Vocab-parallel (``group``, a tensor-parallel rank's group): ``lm_head`` is
this rank's block of the vocabulary's columns, the one JAX's GSPMD gives a
device of the ``tensor`` axis under ``lm_head``'s ("embed", "vocab") dims.
Each rank computes its local ``(m, acc, tgt)`` (the running max, the sum
of exponentials under it, the target's logit where this rank owns the
target) over its own columns, dense or chunk by chunk under the
checkpoint. Three collectives then combine them, outside every
checkpointed chunk (a recompute replays none): the max over the ranks,
with no gradient through it (the loss does not depend on it); the sum of
each rank's exponentials rescaled to that max; and the target's logit
from its owner (the others add 0). The hidden state enters through
``copy_to_tensor``: its gradient is summed over the ranks' columns."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nexus_tpu_torch.parallel.comm import all_reduce
from nexus_tpu_torch.parallel.tensor import copy_to_tensor, reduce_from_tensor


def dense_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                       targets: torch.Tensor, group=None) -> torch.Tensor:
    """hidden (B,S,d) @ lm_head (d,V) → mean NLL of targets (B,S); with a
    ``group``, over this rank's block of the vocabulary (module doc)."""
    if group is not None:
        logits = (copy_to_tensor(hidden, group) @ lm_head).float()
        local, own = _local_targets(targets, lm_head.shape[-1], group)
        m = logits.detach().amax(-1)
        t = torch.gather(logits, -1, local[..., None])[..., 0]
        return _combine(m, torch.exp(logits - m[..., None]).sum(-1), t, own, group)
    logits = (hidden @ lm_head).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return -ll.mean()


def _local_targets(targets: torch.Tensor, v_local: int, group):
    """(each target's column in this rank's block, clamped into it; where
    this rank owns the target)."""
    local = targets.long() - dist.get_rank(group) * v_local
    own = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), own


def _combine(m: torch.Tensor, acc: torch.Tensor, tgt: torch.Tensor, own: torch.Tensor,
             group) -> torch.Tensor:
    """The mean NLL from every rank's (max, sum of exponentials under it,
    target logit where it owns the target): the three collectives of the
    module doc."""
    m_all = all_reduce(m.detach(), group, op=dist.ReduceOp.MAX)
    acc = reduce_from_tensor(acc * torch.exp(m - m_all), group)
    tgt = reduce_from_tensor(torch.where(own, tgt, torch.zeros_like(tgt)), group)
    return (m_all + torch.log(acc) - tgt).mean()


def _chunk_step(hidden, w, targets, m, acc, tgt, start: int, v: int):
    """One vocab chunk of the online logsumexp: columns [start, start+chunk)
    of the padded head; columns ≥ v (the pad) are masked to -inf."""
    chunk = w.shape[1]
    logits = (hidden @ w).float()
    col = torch.arange(start, start + chunk, device=logits.device)
    logits = logits.masked_fill(col >= v, float("-inf"))
    m_new = torch.maximum(m, logits.amax(-1))
    acc = acc * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    local = targets - start
    hit = (local >= 0) & (local < chunk)
    t = torch.gather(logits, -1, local.clamp(0, chunk - 1)[..., None])[..., 0]
    return m_new, acc, torch.where(hit, t, tgt)


def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         targets: torch.Tensor, chunk: int = 4096,
                         group: Optional[object] = None) -> torch.Tensor:
    """Exact cross entropy over vocab chunks; ``chunk`` is clamped to V and
    need not divide it (the tail is padded and masked). With a ``group``,
    over this rank's block of the vocabulary, in chunks of its own columns
    (module doc)."""
    own = None
    if group is not None:
        hidden = copy_to_tensor(hidden, group)
        targets, own = _local_targets(targets, lm_head.shape[-1], group)
    v = lm_head.shape[-1]
    chunk = min(chunk, v)
    n_chunks = -(-v // chunk)
    vp = n_chunks * chunk
    lm_pad = F.pad(lm_head, (0, vp - v)) if vp != v else lm_head
    targets = targets.long()
    b, s = targets.shape
    dev = hidden.device
    m = torch.full((b, s), float("-inf"), device=dev)
    acc = torch.zeros((b, s), device=dev)
    tgt = torch.full((b, s), float("-inf"), device=dev)
    for i in range(n_chunks):
        start = i * chunk
        m, acc, tgt = checkpoint(
            _chunk_step, hidden, lm_pad[:, start:start + chunk], targets,
            m, acc, tgt, start, v, use_reentrant=False,
        )
    if own is not None:
        return _combine(m, acc, tgt, own, group)
    return (m + torch.log(acc) - tgt).mean()
