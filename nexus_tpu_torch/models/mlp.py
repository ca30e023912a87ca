"""MLP "hello world" (counterpart of ``nexus_tpu/models/mlp.py``): the
smallest thing a template can run end to end (BASELINE config #2), a stack
of dense layers with the tanh GELU between them, trained on a regression
MSE. float32 by default.

Parameters keep the JAX package's pytree: ``{"layers": [{"w": (d_in,
d_out), "b": (d_out,)}, ...]}``, a list of dicts, applied as ``x @ w + b``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from nexus_tpu_torch.models.params import fill_normal_, tree_leaves


@dataclass(frozen=True)
class MlpConfig:
    in_dim: int = 16
    hidden_dim: int = 64
    out_dim: int = 8
    n_layers: int = 2
    dtype: torch.dtype = torch.float32


PRESETS = {
    "tiny": dict(in_dim=16, hidden_dim=64, out_dim=8, n_layers=2),
    "small": dict(in_dim=64, hidden_dim=256, out_dim=32, n_layers=3),
}


def config(preset: str = "tiny", **overrides) -> MlpConfig:
    base = dict(PRESETS[preset])
    base.update(overrides)
    if isinstance(base.get("dtype"), str):
        base["dtype"] = getattr(torch, base["dtype"])
    return MlpConfig(**base)


def _dims(cfg: MlpConfig) -> List[int]:
    return [cfg.in_dim] + [cfg.hidden_dim] * (cfg.n_layers - 1) + [cfg.out_dim]


def empty_params(cfg: MlpConfig, device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The parameter pytree with every leaf allocated and not yet written."""
    dims = _dims(cfg)
    return {"layers": [
        {"w": torch.empty((di, do), device=device, dtype=cfg.dtype),
         "b": torch.empty((do,), device=device, dtype=cfg.dtype)}
        for di, do in zip(dims[:-1], dims[1:])]}


def init(generator: torch.Generator, cfg: MlpConfig,
         device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The JAX init's scales: weights normal · 1/sqrt(fan_in), biases
    zeros. Leaves require grad."""
    params = empty_params(cfg, device)
    for layer in params["layers"]:
        fill_normal_(layer["w"], generator, layer["w"].shape[0] ** -0.5)
        layer["b"].zero_()
    for t in leaves(params):
        t.requires_grad_(True)
    return params


def leaves(params: Dict[str, Any]):
    """The parameter tensors in the JAX flatten order (per layer: b, w)."""
    return tree_leaves(params)


def forward(params: Dict[str, Any], cfg: MlpConfig, x: torch.Tensor) -> torch.Tensor:
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return x


def loss_fn(params: Dict[str, Any], cfg: MlpConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Regression MSE. batch: {'x': (B, in_dim), 'y': (B, out_dim)}."""
    pred = forward(params, cfg, batch["x"])
    loss = (pred - batch["y"]).square().mean()
    return loss, {"loss": loss.detach()}
