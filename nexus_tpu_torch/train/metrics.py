"""Throughput and MFU accounting (counterpart of
``nexus_tpu/train/metrics.py``), with peaks of CUDA cards."""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger("nexus_tpu_torch.train")

# Dense bf16 tensor-core peaks of the Hopper cards the kernels are built for
# (NVIDIA data sheets), keyed by a substring of torch.cuda.get_device_name();
# the first match wins, so specific names come before general ones.
PEAK_BF16_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),  # SXM: "NVIDIA H100 80GB HBM3"
    ("H200", 989e12),
)


def model_flops_per_token(cfg, seq_len: Optional[int] = None) -> float:
    """Training FLOPs/token: 6·N plus the attention quadratic term
    (12·L·d·s accounting for QK^T and PV in fwd+bwd)."""
    if hasattr(cfg, "active_param_count"):
        n = cfg.active_param_count()
    elif hasattr(cfg, "param_count"):
        n = cfg.param_count()
    else:
        raise ValueError("config lacks param_count()")
    s = seq_len or cfg.max_seq_len
    attn_flops = 12 * cfg.n_layers * cfg.d_model * s
    return 6.0 * n + attn_flops


def peak_flops_per_chip(device_name: str) -> Optional[float]:
    """Peak bf16 FLOP/s of the named card, or None when it is not in the
    table (a CPU included)."""
    for key, peak in PEAK_BF16_FLOPS:
        if key in device_name:
            return peak
    return None


def mfu(tokens_per_sec: float, flops_per_token: float, device_name: str,
        n_chips: int = 1) -> Optional[float]:
    """Model FLOPs utilisation, or None (with a warning) for a device whose
    peak is unknown: no default peak is assumed."""
    peak = peak_flops_per_chip(device_name)
    if peak is None:
        logger.warning("no bf16 peak known for %r: mfu is not reported", device_name)
        return None
    return tokens_per_sec * flops_per_token / (peak * n_chips)
