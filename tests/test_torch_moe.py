"""The port's MoE routing and dispatch (nexus_tpu_torch.ops.moe) against the
JAX package's (nexus_tpu.ops.moe) on the CPU, on inputs drawn from numpy
seeds.

Tolerances: routing indices, slots, validity, the dispatch mask and the
dropped fraction exactly equal; probabilities, weights, combine weights and
the aux loss f32 (rtol 1e-5, atol 1e-7); dispatch outputs and their
gradients f32 (rtol 1e-5, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.ops import moe as jmoe
from nexus_tpu_torch.ops import moe as tmoe

RTOL, ATOL = 1e-5, 1e-7


def _logits(kind, t, e, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((t, e)).astype(np.float32)
    # exact ties: small integer logits, several equal in every row (and
    # whole rows equal, so the top-k order decides among equals only)
    x = rng.integers(0, 3, (t, e)).astype(np.float32)
    x[::4] = 1.0
    return x


def _routings(logits, k, cap):
    return (jmoe.top_k_routing(jnp.asarray(logits), k, cap),
            tmoe.top_k_routing(torch.from_numpy(logits), k, cap))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("t,e,k,cap", [
    (32, 4, 2, 20),   # room for every selection
    (32, 4, 2, 6),    # capacity overflow: drops
    (48, 8, 2, 3),    # heavy overflow, Mixtral's E and k
    (16, 4, 1, 2),    # top-1
])
def test_top_k_routing_equals_jax_field_by_field(kind, t, e, k, cap):
    ref, got = _routings(_logits(kind, t, e), k, cap)
    for name in ("expert_index", "slot_index", "valid", "dispatch", "dropped_fraction"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("router_probs", "weights", "combine", "aux_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert got.expert_index.dtype == got.slot_index.dtype == torch.int32
    if cap < t * k // e:
        assert float(got.dropped_fraction) > 0


def test_ties_go_to_the_lower_expert_index():
    logits = np.zeros((3, 4), np.float32)
    logits[1] = [1.0, 2.0, 2.0, 2.0]
    logits[2] = [3.0, 0.0, 3.0, 0.0]
    got = tmoe.top_k_routing(torch.from_numpy(logits), 2, 6)
    assert got.expert_index.tolist() == [[0, 1], [1, 2], [0, 2]]


def test_the_scatter_path_builds_no_dense_tensors():
    logits = torch.from_numpy(_logits("random", 32, 4))
    sparse = tmoe.top_k_routing(logits, 2, 6, dense=False)
    dense = tmoe.top_k_routing(logits, 2, 6)
    assert sparse.dispatch is None and sparse.combine is None
    for name in ("expert_index", "slot_index", "valid", "weights", "aux_loss", "dropped_fraction"):
        assert torch.equal(getattr(sparse, name), getattr(dense, name)), name


def _jax_layer(x, logits, scale, g, impl, k, cap):
    e = logits.shape[1]
    r = jmoe.top_k_routing(logits, k, cap)
    if impl == "scatter":
        buf = jmoe.moe_dispatch_scatter(x, r, e, cap)
        out = jmoe.moe_combine_scatter(jnp.tanh(buf * scale[:, None, None]), r)
    else:
        buf = jmoe.moe_dispatch_dense(x, r)
        out = jmoe.moe_combine_dense(jnp.tanh(buf * scale[:, None, None]), r)
    return jnp.sum(out * g) + r.aux_loss


def _port_layer(x, logits, scale, g, impl, k, cap):
    e = logits.shape[1]
    r = tmoe.top_k_routing(logits, k, cap, dense=impl == "einsum")
    if impl == "scatter":
        buf = tmoe.moe_dispatch_scatter(x, r, e, cap)
        out = tmoe.moe_combine_scatter(torch.tanh(buf * scale[:, None, None]), r)
    else:
        buf = tmoe.moe_dispatch_dense(x, r)
        out = tmoe.moe_combine_dense(torch.tanh(buf * scale[:, None, None]), r)
    return torch.sum(out * g) + r.aux_loss, out


@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("cap", [12, 5])
def test_dispatch_outputs_and_gradients_equal_jax(impl, cap):
    """A layer through dispatch → per-expert map → combine: its value and
    the gradients with respect to the tokens and the router logits."""
    t, e, k, d = 24, 4, 2, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((t, d)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, e).astype(np.float32)
    g = rng.standard_normal((t, d)).astype(np.float32)

    ref_val, ref_grads = jax.value_and_grad(_jax_layer, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(logits), jnp.asarray(scale), jnp.asarray(g), impl, k, cap)
    tx = torch.from_numpy(x).requires_grad_()
    tl = torch.from_numpy(logits).requires_grad_()
    val, _ = _port_layer(tx, tl, torch.from_numpy(scale), torch.from_numpy(g), impl, k, cap)
    grads = torch.autograd.grad(val, (tx, tl))
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-5)
    for got, ref, name in zip(grads, ref_grads, ("x", "logits")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_the_two_dispatches_compute_the_same_layer():
    t, e, k, d, cap = 40, 8, 2, 8, 7
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, e).astype(np.float32))
    g = torch.zeros(t, d)
    _, a = _port_layer(x, logits, scale, g, "scatter", k, cap)
    _, b = _port_layer(x, logits, scale, g, "einsum", k, cap)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tokens,e,k,cf", [(8192, 8, 2, 1.25), (8, 8, 2, 1.25), (3, 4, 2, 1.0),
                                           (100, 4, 1, 2.0)])
def test_default_capacity_equals_jax(tokens, e, k, cf):
    assert tmoe.default_capacity(tokens, e, k, cf) == jmoe.default_capacity(tokens, e, k, cf)
