"""Token sampling for autoregressive decode (counterpart of
``nexus_tpu/ops/sampling.py``): temperature, top-k and nucleus / top-p
over a (B, V) logits slab, masking with ``finfo.min`` (never -inf, so a
fully masked row cannot NaN the softmax), and the draw from an explicit
``torch.Generator``. torch's generator gives other numbers than JAX's
threefry from the same seed: the transforms match the JAX function, the
draws follow the same distribution.

A draw is the Gumbel-max of the (B, V) uniforms of one ``torch.rand``
over the whole batch: a rank that decodes rows ``first:first + B`` of a
batch of ``total`` (``rows``) draws the whole batch's uniforms and keeps
its rows', so each row's draw is keyed by its global row index and equals
the one-rank run's."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def row_uniforms(generator: torch.Generator, shape: Tuple[int, ...],
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` (B, ...): rows ``first:first + B``
    of one draw over the ``total`` rows of the batch (``rows`` = (first,
    total); None: the batch is these B rows)."""
    first, total = rows if rows is not None else (0, shape[0])
    u = torch.rand((total,) + tuple(shape[1:]), generator=generator, device=generator.device)
    return u[first:first + shape[0]]


def gumbel_draw(scores: torch.Tensor, generator: torch.Generator,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One draw a row from softmax(``scores``) (B, V): the argmax of the
    scores plus Gumbel noise of ``row_uniforms`` (int64 ids)."""
    u = row_uniforms(generator, tuple(scores.shape), rows).to(scores.device)
    return (scores.float() - torch.log(-torch.log(u))).argmax(dim=-1)


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """logits (B, V) → token ids (B,) int32. temperature == 0 (or no
    generator): greedy. top_k > 0 keeps the k highest logits; top_p < 1 the
    smallest prefix of the sorted distribution holding top_p of the mass
    (always the argmax). ``rows``: the batch rows these are (module doc)."""
    if temperature <= 0.0 or generator is None:
        return logits.argmax(dim=-1).to(torch.int32)
    return gumbel_draw(masked_logits(logits, temperature, top_k, top_p), generator,
                       rows).to(torch.int32)


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
