"""The port's Llama (nexus_tpu_torch.models.llama) against the JAX package's
on the CPU, in float32, with the same weights carried across by
nexus_tpu_torch.interop.llama_params_from_jax.

Tiny model: 2 layers, d 64, 4 query / 2 kv heads, V 256, S 128. Tolerances:
logits and loss rtol 1e-4; parameter gradients rtol 1e-3, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.models import llama as jllama
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import llama as tllama

SEQ = 128


def _jax_setup(attn_impl):
    cfg = jllama.config("tiny", dtype=jnp.float32, attn_impl=attn_impl)
    params = jllama.init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, SEQ + 1)).astype(np.int32)
    return cfg, params, tokens


def _port(jparams, attn_impl, **overrides):
    cfg = tllama.config("tiny", dtype="float32", attn_impl=attn_impl, **overrides)
    params = llama_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, params


def _grads_by_name(tparams, grads):
    names = ["embed"] + [f"layers/{k}" for k in tllama.LAYER_KEYS] + ["final_norm", "lm_head"]
    return dict(zip(names, (g.numpy() for g in grads)))


def _jax_grads_by_name(jgrads):
    out = {k: np.asarray(jgrads[k]) for k in ("embed", "final_norm", "lm_head")}
    out.update({f"layers/{k}": np.asarray(v) for k, v in jgrads["layers"].items()})
    return out


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_forward_logits_and_loss_match_jax(attn_impl):
    """'flash' runs the JAX Pallas kernels in interpret mode and the port's
    flash path through its kernels' plain versions."""
    jcfg, jparams, tokens = _jax_setup(attn_impl)
    tcfg, tparams = _port(jparams, attn_impl)
    ref_logits = np.asarray(jllama.forward(jparams, jcfg, jnp.asarray(tokens[:, :-1])))
    ref_loss, _ = jllama.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        logits = tllama.forward(tparams, tcfg, t[:, :-1])
        loss, metrics = tllama.loss_fn(tparams, tcfg, {"tokens": t})
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(metrics["perplexity"].item(), float(np.exp(ref_loss)), rtol=1e-4)


@pytest.mark.parametrize("attn_impl,ce_chunk", [("xla", 0), ("flash", 0), ("xla", 100)])
def test_parameter_gradients_match_jax(attn_impl, ce_chunk):
    jcfg, jparams, tokens = _jax_setup(attn_impl)
    if ce_chunk:
        jcfg = jllama.config("tiny", dtype=jnp.float32, attn_impl=attn_impl, ce_chunk=ce_chunk)
    tcfg, tparams = _port(jparams, attn_impl, ce_chunk=ce_chunk)
    jgrads = jax.grad(lambda p: jllama.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(jparams)
    loss, _ = tllama.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, tllama.leaves(tparams))
    got, ref = _grads_by_name(tparams, grads), _jax_grads_by_name(jgrads)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_full_remat_gives_the_same_gradients(attn_impl):
    """Recompute under torch.utils.checkpoint reruns the same ops (the flash
    autograd Function included): gradients equal to float32 noise
    (rtol 1e-5, atol 1e-7)."""
    _, jparams, tokens = _jax_setup(attn_impl)
    batch = {"tokens": torch.from_numpy(tokens)}
    out = []
    for remat in (False, True):
        cfg, params = _port(jparams, attn_impl, remat=remat, remat_policy="full")
        loss, _ = tllama.loss_fn(params, cfg, batch)
        out.append(torch.autograd.grad(loss, tllama.leaves(params)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_init_scales_and_layout_follow_the_jax_init():
    """Same shapes and dtypes as the JAX init, and the same scale per tensor
    (std within 10% of the JAX draw's; norms are exactly ones)."""
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    jparams = jllama.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.config("tiny", dtype="float32")
    gen = torch.Generator().manual_seed(0)
    tparams = tllama.init(gen, tcfg, "cpu")
    flat_j = _jax_grads_by_name(jparams)
    flat_t = _grads_by_name(tparams, [p.detach() for p in tllama.leaves(tparams)])
    for name, ref in flat_j.items():
        got = flat_t[name]
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        if "ln_" in name or name == "final_norm":
            assert np.all(got == 1.0), name
        else:
            np.testing.assert_allclose(got.std(), ref.std(), rtol=0.1, err_msg=name)
    assert tcfg.param_count() == jcfg.param_count() == sum(
        p.numel() for p in tllama.leaves(tparams))


def test_interop_rejects_a_tree_of_another_config():
    _, jparams, _ = _jax_setup("xla")
    cfg = tllama.config("tiny", dtype="float32", d_ff=256)
    with pytest.raises(ValueError, match="w_gate"):
        llama_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def test_config_accepts_dtype_strings_and_presets_match():
    assert tllama.config("tiny", dtype="bfloat16").dtype == torch.bfloat16
    for name, preset in jllama.PRESETS.items():
        assert tllama.PRESETS[name] == preset
        assert tllama.config(name).param_count() == jllama.config(name).param_count()
