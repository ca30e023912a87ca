"""Normalization ops (counterpart of ``nexus_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (Llama-style): normalize in fp32, scale, cast back."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (GPT-NeoX-style, with bias): normalize in fp32, apply the
    weight and bias in fp32, cast back."""
    x32 = x.float()
    centred = x32 - x32.mean(-1, keepdim=True)
    var = centred.square().mean(-1, keepdim=True)
    return (centred * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)
