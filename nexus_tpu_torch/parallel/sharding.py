"""Sharding rules (counterpart of ``nexus_tpu/parallel/sharding.py``).

``DEFAULT_LOGICAL_RULES`` and ``logical_to_spec`` are JAX's map of logical
tensor dims onto mesh axes, kept as the record of the layout JAX runs. The
port applies the batch rows (``data``, ``fsdp``) and the sequence
(``sequence``) by hand: ``batch_spec`` cuts this rank's slice out of the
global batch. Parameters stay whole on every rank; the trainer shards the
optimizer state over ``fsdp`` (train/trainer.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from nexus_tpu_torch.parallel.mesh import Mesh

# logical dim name → physical mesh axis (or tuple of axes)
DEFAULT_LOGICAL_RULES: Dict[Any, Any] = {
    "batch": ("data", "fsdp"),
    "seq": "sequence",
    "vocab": "tensor",
    "embed": "fsdp",
    "mlp": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "qkv": "tensor",
    "expert": "expert",
    "norm": None,
    "layer": None,
    None: None,
}


def logical_to_spec(logical_dims: Tuple[Optional[str], ...],
                    rules: Optional[Dict[Any, Any]] = None) -> Tuple[Any, ...]:
    """("vocab", "embed") → ("tensor", "fsdp"): JAX's PartitionSpec as a
    tuple."""
    rules = rules or DEFAULT_LOGICAL_RULES
    return tuple(rules.get(d) for d in logical_dims)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def batch_spec(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, np.ndarray]:
    """This rank's slice of a global batch: rows split over ``data`` ×
    ``fsdp`` (data outer, as JAX's ``P(("data", "fsdp"))`` lays them), and
    the (B, S+1) ``tokens`` columns over ``sequence``. The input/target
    shift is taken before the cut: a rank keeps S/n + 1 columns, the
    inputs of its S/n positions and their targets, one past its block."""
    dp = mesh.size("data", "fsdp")
    rows = _block(next(iter(batch.values())).shape[0], dp,
                  mesh.index("data") * mesh.shape["fsdp"] + mesh.index("fsdp"), "batch")
    out = {k: x[rows] for k, x in batch.items()}
    n_seq = mesh.shape["sequence"]
    if "tokens" in out and n_seq > 1:
        tokens = out["tokens"]
        cols = _block(tokens.shape[1] - 1, n_seq, mesh.index("sequence"), "sequence")
        out["tokens"] = tokens[:, cols.start:cols.stop + 1]
    return out
