"""Next-token cross entropy (counterpart of ``nexus_tpu/ops/losses.py``).

``dense_softmax_xent`` materialises the (B, S, V) f32 logits.
``chunked_softmax_xent`` computes the same mean NLL over vocab chunks with an
online logsumexp; each chunk runs under ``torch.utils.checkpoint``, so the
backward recomputes the chunk's logits instead of saving them and peak
logits memory is O(B·S·chunk) instead of O(B·S·V)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """hidden (B,S,d) @ lm_head (d,V) → mean NLL of targets (B,S)."""
    logits = (hidden @ lm_head).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return -ll.mean()


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
                         targets: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Exact cross entropy over vocab chunks; ``chunk`` is clamped to V and
    need not divide it (the tail is padded and masked)."""
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
    return (m + torch.log(acc) - tgt).mean()
