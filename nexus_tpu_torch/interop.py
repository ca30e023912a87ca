"""Carry the JAX package's parameters into the port.

``llama_params_from_jax(np_tree, cfg, device)`` takes the JAX llama param
pytree with numpy leaves (e.g. ``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict: the same layout (stacked layers,
``x @ W`` products), so both compute the same function."""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from nexus_tpu_torch.models.llama import LAYER_KEYS, LlamaConfig, leaves, param_shapes


def llama_params_from_jax(np_tree: Dict[str, Any], cfg: LlamaConfig,
                          device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    shapes = param_shapes(cfg)

    def conv(name, x):
        x = np.asarray(x, dtype=np.float32)
        if x.shape != shapes[name]:
            raise ValueError(f"{name}: shape {x.shape} != the config's {shapes[name]}")
        return torch.from_numpy(x.copy()).to(device=device, dtype=cfg.dtype)

    params = {
        "embed": conv("embed", np_tree["embed"]),
        "layers": {k: conv(k, np_tree["layers"][k]) for k in LAYER_KEYS},
        "final_norm": conv("final_norm", np_tree["final_norm"]),
        "lm_head": conv("lm_head", np_tree["lm_head"]),
    }
    for t in leaves(params):
        t.requires_grad_(True)
    return params
