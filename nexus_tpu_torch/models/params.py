"""What the model families share about their parameter dicts: random
initialisation one slice at a time, and the flatten order of the JAX
package's pytrees.

``fill_normal_`` draws a stacked weight one slice of its leading (layer,
expert) dims at a time, in f32 on the generator's device, and writes each
slice scaled into the tensor: the peak over the weights is one slice in
f32, never the whole stack (at Mixtral-8x7B widths the stacked ``w_gate``
alone is 30 GB in f32).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Tuple, Union

import torch


@torch.no_grad()
def fill_normal_(out: torch.Tensor, generator: torch.Generator, scale: float,
                 stack_dims: int = 0) -> torch.Tensor:
    """Fill ``out`` with N(0, 1) · ``scale``, drawn slice by slice over its
    first ``stack_dims`` dims."""
    slice_shape = tuple(out.shape[stack_dims:])
    for idx in itertools.product(*(range(n) for n in out.shape[:stack_dims])):
        x = torch.randn(slice_shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        out[idx].copy_(x.mul_(scale))
    return out


def tree_items(tree: Union[Dict[str, Any], list], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of nested dicts and lists in the JAX pytree flatten
    order: a dict's values by sorted key, a list's by index, at every
    level. A transformer's dict gives ``embed``, ``final_norm``,
    ``layers/<name>`` by name, ``lm_head``; the MLP's list of layers gives
    ``layers/0/b``, ``layers/0/w``, ``layers/1/b``, ..."""
    pairs = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    for key, value in pairs:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            yield from tree_items(value, path + "/")
        else:
            yield path, value


def tree_leaves(tree: Union[Dict[str, Any], list]) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]
