"""Carry the JAX package's parameters into the port.

``llama_params_from_jax(np_tree, cfg, device)`` and
``mixtral_params_from_jax(np_tree, cfg, device)`` take the JAX family's
param pytree with numpy leaves (e.g. ``jax.tree.map(np.asarray, params)``)
and return the port's parameter dict: the same layout (stacked layers,
``x @ W`` products), so both compute the same function. Every leaf's shape
is checked against the config; Mixtral's router stays float32."""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from nexus_tpu_torch.models import llama, mixtral


def _params_from_jax(family, np_tree: Dict[str, Any], cfg, device) -> Dict[str, Any]:
    like = family.empty_params(cfg, "meta")  # each leaf's shape and dtype

    def conv(x, ref, name):
        x = np.asarray(x, dtype=np.float32)
        if x.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {x.shape} != the config's {tuple(ref.shape)}")
        return torch.from_numpy(x.copy()).to(device=device, dtype=ref.dtype)

    params = {k: conv(np_tree[k], like[k], k) for k in ("embed", "final_norm", "lm_head")}
    params["layers"] = {k: conv(np_tree["layers"][k], like["layers"][k], k)
                        for k in family.LAYER_KEYS}
    for t in family.leaves(params):
        t.requires_grad_(True)
    return params


def llama_params_from_jax(np_tree: Dict[str, Any], cfg: llama.LlamaConfig,
                          device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    return _params_from_jax(llama, np_tree, cfg, device)


def mixtral_params_from_jax(np_tree: Dict[str, Any], cfg: mixtral.MixtralConfig,
                            device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    return _params_from_jax(mixtral, np_tree, cfg, device)
