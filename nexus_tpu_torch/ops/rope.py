"""Rotary position embeddings, Llama-3 convention (counterpart of
``nexus_tpu/ops/rope.py``): pairs are the two halves of the head,
``(x[..., :half], x[..., half:])``, not interleaved elements."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def rope_cos_sin(
    seq_len: int,
    head_dim: int,
    theta: float = 500000.0,
    dtype: torch.dtype = torch.float32,
    position_offset: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (seq_len, head_dim/2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    positions = torch.arange(seq_len, dtype=torch.float32, device=device) + position_offset
    angles = torch.outer(positions, freqs)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (x[..., :half], x[..., half:]); x: (..., seq, heads, head_dim),
    cos/sin: (seq, half) or (batch, seq, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
