"""The port's remat policies (nexus_tpu_torch.ops.remat): ``dots`` and
``dots_attn`` against ``full`` and no remat, on the CPU in float32, for the
tiny Llama and Mixtral, with weights carried from the JAX package's init.

Gradients under every policy equal the plain backward's to f32 noise (rtol
1e-5, atol 1e-7): a policy changes what is kept, never what is computed.
The flash forward (its plain version on the CPU, counted) runs once per
layer for a forward and backward under ``dots_attn`` and twice under
``full`` and ``dots`` (the recompute reruns it); so does the dense path's
PV product, the op that stands for the JAX blocks' ``ATTN_OUT_NAME``. ``dots`` keeps the
products with no batch dims (``aten.mm``) and recomputes the experts'
batched products (``aten.bmm``), as JAX's
``dots_with_no_batch_dims_saveable`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from nexus_tpu.models import llama as jllama
from nexus_tpu.models import mixtral as jmix
from nexus_tpu_torch.interop import llama_params_from_jax, mixtral_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.ops import attention as A
from nexus_tpu_torch.ops import remat

FAMILIES = {"llama": (jllama, tllama, llama_params_from_jax),
            "mixtral": (jmix, tmix, mixtral_params_from_jax)}
POLICIES = (None, "full", "dots", "dots_attn")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the flash forward's runs (its plain version: the kernel's
    CPU path)."""
    calls = [0]
    plain = A.flash_fwd_plain

    def counting(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(A, "flash_fwd_plain", counting)
    return calls


def _grads(family, policy, attn_impl, tokens):
    jfam, tfam, conv = FAMILIES[family]
    jparams = jfam.init(jax.random.PRNGKey(0), jfam.config("tiny", dtype=jnp.float32))
    over = dict(attn_impl=attn_impl, remat=policy is not None, remat_policy=policy or "full")
    if family == "mixtral":
        over["dispatch_impl"] = "scatter"
    cfg = tfam.config("tiny", dtype="float32", **over)
    params = conv(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    loss, _ = tfam.loss_fn(params, cfg, {"tokens": torch.from_numpy(tokens)})
    return torch.autograd.grad(loss, tfam.leaves(params)), cfg.n_layers


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (2, 129)).astype(np.int64)


@pytest.mark.parametrize("family", ["llama", "mixtral"])
@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_every_policy_gives_the_plain_gradients(family, attn_impl):
    tokens = _tokens()
    ref, _ = _grads(family, None, attn_impl, tokens)
    for policy in POLICIES[1:]:
        got, _ = _grads(family, policy, attn_impl, tokens)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=policy)


@pytest.mark.parametrize("family", ["llama", "mixtral"])
@pytest.mark.parametrize("policy,per_layer", [(None, 1), ("full", 2), ("dots", 2),
                                              ("dots_attn", 1)])
def test_the_flash_forward_runs_once_per_layer_under_dots_attn(family, policy, per_layer,
                                                               flash_calls):
    _, n_layers = _grads(family, policy, "flash", _tokens())
    assert flash_calls[0] == per_layer * n_layers


class _OpCount(TorchDispatchMode):
    """Counts the dispatches of one op: a recompute that returns a saved
    output never dispatches it."""

    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is self.op
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", ["llama", "mixtral"])
@pytest.mark.parametrize("policy,per_layer", [(None, 1), ("full", 2), ("dots", 2),
                                              ("dots_attn", 1)])
def test_the_dense_attention_output_is_kept_under_dots_attn(family, policy, per_layer):
    """The dense path's counterpart of the JAX blocks' ATTN_OUT_NAME: its
    PV product (nexus::attn_out) runs once per layer under dots_attn."""
    with _OpCount(torch.ops.nexus.attn_out.default) as count:
        _, n_layers = _grads(family, policy, "xla", _tokens())
    assert count.n == per_layer * n_layers


def test_dots_keeps_the_plain_products_and_recomputes_the_batched_ones(monkeypatch):
    """The policy's decisions on the Mixtral block's first (forward) pass."""
    seen = {}
    make = remat._saving

    def recording(ops):
        policy = make(ops)

        def wrapped(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                seen.setdefault(op, set()).add(decision)
            return decision

        return wrapped

    monkeypatch.setattr(remat, "_saving", recording)
    _grads("mixtral", "dots", "flash", _tokens())
    aten = torch.ops.aten
    assert seen[aten.mm.default] == {CheckpointPolicy.MUST_SAVE}
    assert seen[aten.bmm.default] == {CheckpointPolicy.PREFER_RECOMPUTE}
    assert seen[torch.ops.nexus.flash_fwd.default] == {CheckpointPolicy.PREFER_RECOMPUTE}
    saved = {op for op, d in seen.items() if CheckpointPolicy.MUST_SAVE in d}
    assert saved <= remat.DOT_OPS
    seen.clear()
    _grads("mixtral", "dots_attn", "flash", _tokens())
    assert seen[torch.ops.nexus.flash_fwd.default] == {CheckpointPolicy.MUST_SAVE}
    assert seen[aten.bmm.default] == {CheckpointPolicy.PREFER_RECOMPUTE}
    seen.clear()
    _grads("mixtral", "dots", "xla", _tokens())
    assert seen[torch.ops.nexus.attn_out.default] == {CheckpointPolicy.PREFER_RECOMPUTE}
    seen.clear()
    _grads("mixtral", "dots_attn", "xla", _tokens())
    assert seen[torch.ops.nexus.attn_out.default] == {CheckpointPolicy.MUST_SAVE}
    assert seen[aten.bmm.default] == {CheckpointPolicy.PREFER_RECOMPUTE}


def test_an_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy 'offload'"):
        remat.checkpoint_block(lambda x: x, "offload")
    assert remat.REMAT_POLICIES == ("full", "dots", "dots_attn")
