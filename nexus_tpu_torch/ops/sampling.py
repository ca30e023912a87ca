"""Token sampling for autoregressive decode (counterpart of
``nexus_tpu/ops/sampling.py``): temperature, top-k and nucleus / top-p
over a (B, V) logits slab, masking with ``finfo.min`` (never -inf, so a
fully masked row cannot NaN the softmax), and the draw from an explicit
``torch.Generator``. torch's generator gives other numbers than JAX's
threefry from the same seed: the transforms match the JAX function, the
draws follow the same distribution."""

from __future__ import annotations

from typing import Optional

import torch


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """logits (B, V) → token ids (B,) int32. temperature == 0 (or no
    generator): greedy. top_k > 0 keeps the k highest logits; top_p < 1 the
    smallest prefix of the sorted distribution holding top_p of the mass
    (always the argmax)."""
    if temperature <= 0.0 or generator is None:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = masked_logits(logits, temperature, top_k, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def masked_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """The tempered logits with what top-k and top-p drop set to
    ``finfo(float32).min`` (the JAX function's transforms, before its
    draw)."""
    logits = logits.float() / temperature
    neg = torch.finfo(torch.float32).min
    if top_k and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, neg), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cdf = torch.cumsum(probs, dim=-1)
        # keep every position whose preceding mass is < top_p
        keep = (cdf - probs) < top_p
        cutoff = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, torch.full_like(logits, neg), logits)
    return logits
