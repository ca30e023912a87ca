"""Carry the JAX package's parameters into the port.

``llama_params_from_jax``, ``mixtral_params_from_jax``,
``gptneox_params_from_jax`` and ``mlp_params_from_jax`` each take ``(np_tree,
cfg, device)``: the JAX family's param pytree with numpy leaves (e.g.
``jax.tree.map(np.asarray, params)``), and return the port's parameter
pytree: the same layout (stacked layers, ``x @ W`` products; the MLP's list
of layers), so both compute the same function. Every leaf's shape is checked
against the config; Mixtral's router stays float32. Each takes a ``mesh``
(or a ``ModelShard``) too: the params then come
back as that rank's blocks over the model axes
(``parallel/sharding.py::shard_params``)."""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from nexus_tpu_torch.models import gptneox, llama, mixtral, mlp
from nexus_tpu_torch.parallel.sharding import shard_params


def _params_from_jax(family, np_tree: Dict[str, Any], cfg, device, mesh=None) -> Dict[str, Any]:
    like = family.empty_params(cfg, "meta")  # each leaf's shape and dtype

    def conv(x, ref, name):
        if isinstance(ref, dict):
            return {k: conv(x[k], r, f"{name}/{k}".lstrip("/")) for k, r in ref.items()}
        if isinstance(ref, list):
            if len(x) != len(ref):
                raise ValueError(f"{name}: {len(x)} entries != the config's {len(ref)}")
            return [conv(xi, r, f"{name}/{i}") for i, (xi, r) in enumerate(zip(x, ref))]
        x = np.asarray(x, dtype=np.float32)
        if x.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {x.shape} != the config's {tuple(ref.shape)}")
        return torch.from_numpy(x.copy()).to(device=device, dtype=ref.dtype)

    params = conv(np_tree, like, "")
    if mesh is not None:
        params = shard_params(params, family.logical_axes(cfg), mesh, family.TENSOR_GROUPS)
    for t in family.leaves(params):
        t.requires_grad_(True)
    return params


def llama_params_from_jax(np_tree: Dict[str, Any], cfg: llama.LlamaConfig,
                          device: Union[str, torch.device] = "cpu", mesh=None) -> Dict[str, Any]:
    return _params_from_jax(llama, np_tree, cfg, device, mesh)


def mixtral_params_from_jax(np_tree: Dict[str, Any], cfg: mixtral.MixtralConfig,
                            device: Union[str, torch.device] = "cpu",
                            mesh=None) -> Dict[str, Any]:
    return _params_from_jax(mixtral, np_tree, cfg, device, mesh)


def gptneox_params_from_jax(np_tree: Dict[str, Any], cfg: gptneox.GPTNeoXConfig,
                            device: Union[str, torch.device] = "cpu",
                            mesh=None) -> Dict[str, Any]:
    return _params_from_jax(gptneox, np_tree, cfg, device, mesh)


def mlp_params_from_jax(np_tree: Dict[str, Any], cfg: mlp.MlpConfig,
                        device: Union[str, torch.device] = "cpu", mesh=None) -> Dict[str, Any]:
    return _params_from_jax(mlp, np_tree, cfg, device, mesh)
