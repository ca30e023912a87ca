"""MLP "hello world" (counterpart of ``nexus_tpu/models/mlp.py``): the
smallest thing a template can run end to end (BASELINE config #2), a stack
of dense layers with the tanh GELU between them, trained on a regression
MSE. float32 by default.

Parameters keep the JAX package's pytree: ``{"layers": [{"w": (d_in,
d_out), "b": (d_out,)}, ...]}``, a list of dicts, applied as ``x @ w + b``.

Tensor parallelism: JAX's logical dims put every layer's output columns
(``mlp``) on the ``tensor`` axis. Params cut by those dims
(``parallel/sharding.py``) hold a rank's columns of each ``w`` and ``b``;
``forward`` feeds each layer the whole activations (``copy_to_tensor``:
their gradient is summed over the ranks' columns) and gathers the rank's
output columns back into the whole activations (``gather_from_tensor``),
as GSPMD reshards them between the layers, so every rank computes the same
prediction and loss. Over ``fsdp`` (training) each rank holds a block of
every ``w``'s input rows (``embed``), gathered whole where the layer runs
(parallel/fsdp.py); the biases stay whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from nexus_tpu_torch.models.params import LeafCuts, tree_leaves
from nexus_tpu_torch.parallel.fsdp import fsdp_group, gather_one
from nexus_tpu_torch.parallel.tensor import copy_to_tensor, gather_from_tensor, tensor_mesh


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


def logical_axes(cfg: MlpConfig) -> Dict[str, Any]:
    """Each leaf's logical dims (JAX's ``logical_axes``): a layer's output
    columns are ``mlp``, its input rows ``embed``."""
    return {"layers": [{"w": ("embed", "mlp"), "b": ("mlp",)} for _ in range(cfg.n_layers)]}


# no fused leaf: every cut dim is one run (parallel/sharding.py::shard_params)
TENSOR_GROUPS: Dict[str, int] = {}


def empty_params(cfg: MlpConfig, device: Union[str, torch.device] = "cuda",
                 shard=None) -> Dict[str, Any]:
    """The parameter pytree with every leaf allocated and not yet written;
    with a ``parallel.sharding.ModelShard``, each leaf is this rank's
    block."""
    dims = _dims(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)

    def empty(path, shape):
        return torch.empty(cuts.shape(path, shape), device=device, dtype=cfg.dtype)

    return {"layers": [
        {"w": empty(f"layers/{i}/w", (di, do)), "b": empty(f"layers/{i}/b", (do,))}
        for i, (di, do) in enumerate(zip(dims[:-1], dims[1:]))]}


def init(generator: torch.Generator, cfg: MlpConfig,
         device: Union[str, torch.device] = "cuda", shard=None) -> Dict[str, Any]:
    """The JAX init's scales: weights normal · 1/sqrt(fan_in), biases
    zeros. With a ``ModelShard`` every weight is drawn whole and the rank
    keeps its columns: the one-rank draw's values. Leaves require grad."""
    dims = _dims(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)
    params = empty_params(cfg, device, shard)
    for i, (layer, di, do) in enumerate(zip(params["layers"], dims[:-1], dims[1:])):
        cuts.fill_normal_(f"layers/{i}/w", layer["w"], (di, do), generator, di ** -0.5)
        layer["b"].zero_()
    for t in leaves(params):
        t.requires_grad_(True)
    return params


def leaves(params: Dict[str, Any]):
    """The parameter tensors in the JAX flatten order (per layer: b, w)."""
    return tree_leaves(params)


def tensor_group(params: Dict[str, Any], cfg: MlpConfig):
    """The process group of the tensor axis the params were cut for (the
    config's output width over the one the params hold), or None for whole
    params."""
    degree = cfg.out_dim // params["layers"][-1]["b"].shape[0]
    return None if degree == 1 else tensor_mesh(degree).group("tensor")


def forward(params: Dict[str, Any], cfg: MlpConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, in_dim) → (B, out_dim), the whole prediction on every rank of
    a tensor axis (module doc)."""
    layers = params["layers"]
    group = tensor_group(params, cfg)
    fsdp = fsdp_group(cfg.in_dim, layers[0]["w"].shape[0])
    for i, layer in enumerate(layers):
        w = gather_one(layer["w"], 0, fsdp)
        x = gather_from_tensor(copy_to_tensor(x, group) @ w + layer["b"], group)
        if i < len(layers) - 1:
            x = F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return x


def loss_fn(params: Dict[str, Any], cfg: MlpConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Regression MSE. batch: {'x': (B, in_dim), 'y': (B, out_dim)}."""
    pred = forward(params, cfg, batch["x"])
    loss = (pred - batch["y"]).square().mean()
    return loss, {"loss": loss.detach()}
