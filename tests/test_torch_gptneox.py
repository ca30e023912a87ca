"""The port's GPT-NeoX (nexus_tpu_torch.models.gptneox) against the JAX
package's on the CPU, with the same weights carried across by
nexus_tpu_torch.interop.gptneox_params_from_jax.

Models: preset ``tiny`` (d 64, 4 heads of 16, 4 rotary dims), a head-dim-96
override (d 192, 2 heads, rotary_pct 0.25: 24 rotary dims) and, on the
flash path, a head-dim-128 override (d 256, 2 heads: the JAX Pallas
kernels in interpret mode against the port's kernels' plain versions);
2 layers, V 256, S 128. Tolerances: f32 logits, loss metrics and gradients
rtol 1e-5, atol 1e-6 (the Mixtral tests' limits); bf16 2e-2 of the
reference's norm, each tensor as a whole; greedy tokens exactly equal in
f32; remat policies' gradients equal to the plain run's within f32 noise
(rtol 1e-5, atol 1e-7).

``jax.nn.gelu`` is the tanh approximation; PyTorch's default GELU is erf.
The two differ by ~1e-3, which bf16 hides, so an f32 case shows that the
limit sees it.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import gptneox as jneox
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.interop import gptneox_params_from_jax
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.train import checkpoint as tck
from nexus_tpu_torch.train import trainer as ttrainer

SEQ = 128
# name -> config overrides of preset tiny
SHAPES = {"d16": {}, "d96": dict(d_model=192, n_heads=2),
          "d128-flash": dict(d_model=256, n_heads=2, attn_impl="flash")}
TOP = ("embed", "final_norm", "final_norm_b", "lm_head")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch at these tiny
    shapes gains nothing from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(shape="d16", dtype="float32", **over):
    over = dict(SHAPES[shape], **over)
    jcfg = jneox.config("tiny", dtype=getattr(jnp, dtype), **over)
    jparams = jneox.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tneox.config("tiny", dtype=dtype, **over)
    tparams = gptneox_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return (jcfg, jparams), (tcfg, tparams)


def _tokens(seed=0, b=2, s=SEQ + 1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _by_name(tree):
    out = {k: np.asarray(tree[k], np.float32) for k in TOP}
    out.update({f"layers/{k}": np.asarray(v, np.float32) for k, v in tree["layers"].items()})
    return out


def _port_grads(grads):
    names = ["embed"] + [f"layers/{k}" for k in tneox.LAYER_KEYS] + list(TOP[1:])
    return {n: g.float().numpy() for n, g in zip(names, grads)}


def _near(got, ref, rel, name=""):
    """Each tensor as a whole: ||got - ref|| <= rel ||ref||."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.linalg.norm(got - ref)
    assert err <= rel * np.linalg.norm(ref), f"{name}: {err / np.linalg.norm(ref):.3g} > {rel}"


CASES = [("d16", "float32"), ("d96", "float32"), ("d128-flash", "float32"),
         ("d16", "bfloat16"), ("d96", "bfloat16")]


@pytest.mark.parametrize("shape,dtype", CASES)
def test_forward_and_loss_metrics_match_jax(shape, dtype):
    (jcfg, jp), (tcfg, tp) = _models(shape, dtype)
    tokens = _tokens()
    t = torch.from_numpy(tokens)
    ref_logits = np.asarray(jneox.forward(jp, jcfg, jnp.asarray(tokens[:, :-1])))
    _, ref_m = jneox.loss_fn(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits = tneox.forward(tp, tcfg, t[:, :-1])
        _, m = tneox.loss_fn(tp, tcfg, {"tokens": t})
    assert logits.dtype == torch.float32 and logits.shape == (2, SEQ, 256)
    assert set(m) == set(ref_m) == {"loss", "perplexity"}
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5, atol=1e-6)
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(ref_m[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    else:
        _near(logits.numpy(), ref_logits, 2e-2, "logits")
        for k in m:
            _near(m[k].item(), float(ref_m[k]), 2e-2, k)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_parameter_gradients_match_jax(shape, dtype):
    (jcfg, jp), (tcfg, tp) = _models(shape, dtype)
    tokens = _tokens(1)
    jgrads = jax.grad(lambda p: jneox.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(jp)
    loss, _ = tneox.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    got = _port_grads(torch.autograd.grad(loss, tneox.leaves(tp)))
    ref = _by_name(jgrads)
    assert got.keys() == ref.keys()
    for name in ref:
        if dtype == "float32":
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            _near(got[name], ref[name], 2e-2, name)


def test_the_chunked_loss_matches_jax():
    (jcfg, jp), (tcfg, tp) = _models("d96", ce_chunk=100)
    tokens = _tokens(2)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jneox.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(jp)
    loss, _ = tneox.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    got = _port_grads(torch.autograd.grad(loss, tneox.leaves(tp)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, ref in _by_name(jgrads).items():
        np.testing.assert_allclose(got[name], ref, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("policy", ["full", "dots", "dots_attn"])
@pytest.mark.parametrize("shape", ["d96", "d128-flash"])
def test_every_remat_policy_gives_the_plain_gradients(shape, policy):
    """Recompute reruns the same ops (the dense path's ``nexus::attn_out``
    at D 96, the flash forward's op at D 128): gradients equal to the
    plain run's within f32 noise."""
    _, (_, tp) = _models(shape)
    batch = {"tokens": torch.from_numpy(_tokens(3))}
    out = []
    for remat in (False, True):
        cfg = tneox.config("tiny", dtype="float32", remat=remat, remat_policy=policy,
                           **SHAPES[shape])
        loss, _ = tneox.loss_fn(tp, cfg, batch)
        out.append(torch.autograd.grad(loss, tneox.leaves(tp)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_erf_gelu_fails_the_f32_limit(monkeypatch):
    """The same model with PyTorch's default (erf) GELU misses the f32
    limit the tanh GELU meets: the forward test sees the difference."""
    (jcfg, jp), (tcfg, tp) = _models("d96")
    tokens = _tokens()
    ref = np.asarray(jneox.forward(jp, jcfg, jnp.asarray(tokens[:, :-1])))
    erf_gelu = SimpleNamespace(gelu=lambda x, approximate: F.gelu(x))  # approximate="none"
    monkeypatch.setattr(tneox, "F", erf_gelu)
    with torch.no_grad():
        erf = tneox.forward(tp, tcfg, torch.from_numpy(tokens[:, :-1])).numpy()
    excess = np.abs(erf - ref) - (1e-6 + 1e-5 * np.abs(ref))
    assert excess.max() > 0, "erf GELU passed the f32 limit"


@pytest.mark.parametrize("rotary_pct", [0.25, 1.0])
def test_the_attention_inputs_pass_the_flash_kernels_checks(rotary_pct):
    """q, k and v of the fused QKV are what the flash kernels take on the
    card (bf16, contiguous, D 128): a strided third of the QKV product
    would be refused there."""
    from nexus_tpu_torch.ops import attention as tattn
    from nexus_tpu_torch.ops.rope import rope_cos_sin

    cfg = tneox.config("tiny", dtype="bfloat16", rotary_pct=rotary_pct, **SHAPES["d128-flash"])
    params = tneox.init(torch.Generator().manual_seed(0), cfg, "cpu")
    layer = {k: v[0].detach() for k, v in params["layers"].items()}
    cos, sin = rope_cos_sin(SEQ, cfg.rotary_dims, cfg.rope_theta)
    h = torch.randn(2, SEQ, cfg.d_model).bfloat16()
    q, k, v = tneox._qkv(cfg, h, layer, cos, sin)
    assert tattn._check_cuda(q, k, v, causal=True, window=0) == (2, SEQ, SEQ, 2, 2, 128)


def test_partial_rotary_dims_and_presets_match_jax():
    for name, preset in jneox.PRESETS.items():
        assert tneox.PRESETS[name] == preset
        j, t = jneox.config(name), tneox.config(name)
        assert (t.head_dim, t.n_kv_heads, t.rotary_dims, t.param_count()) == (
            j.head_dim, j.n_kv_heads, j.rotary_dims, j.param_count())
    assert tneox.config("20b").rotary_dims == 24 and tneox.config("20b").head_dim == 96
    assert tneox.config("1b").rotary_dims == 32
    assert tneox.config("tiny").rotary_dims == 4
    assert tneox.config("tiny", **SHAPES["d96"]).rotary_dims == 24
    assert tneox.config("20b").param_count() == 20_554_567_680  # GPT-NeoX-20B's 20.55 B
    assert tneox.config("tiny").rope_theta == 10000.0
    assert tneox.config("tiny", dtype="bfloat16").dtype == torch.bfloat16


def test_init_scales_and_layout_follow_the_jax_init():
    """Shapes and dtypes of the JAX init, the same scale per tensor (std
    within 10%), biases zeros, LayerNorm weights ones, every layer its own
    draw."""
    jcfg = jneox.config("tiny", dtype=jnp.float32, n_layers=4)
    jparams = jneox.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tneox.config("tiny", dtype="float32", n_layers=4)
    tp = tneox.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    got = _port_grads([p.detach() for p in tneox.leaves(tp)])
    for name, ref in _by_name(jparams).items():
        assert got[name].shape == ref.shape, name
        if name.endswith("_b") or "b_" in name:
            assert np.all(got[name] == 0.0), name
        elif name in ("layers/ln1", "layers/ln2", "final_norm"):
            assert np.all(got[name] == 1.0), name
        else:
            np.testing.assert_allclose(got[name].std(), ref.std(), rtol=0.1, err_msg=name)
    assert tcfg.param_count() == sum(p.numel() for p in tneox.leaves(tp))
    wqkv = tp["layers"]["wqkv"]
    assert not torch.equal(wqkv[0], wqkv[1])


def test_interop_rejects_a_tree_of_another_config():
    (_, jp), _ = _models()
    cfg = tneox.config("tiny", dtype="float32", d_ff=128)
    with pytest.raises(ValueError, match="w_in"):
        gptneox_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def test_ring_attention_names_its_roadmap_item():
    """attn_impl 'ring' with no sharded sequence axis (one device) is plain
    attention in both packages: the same logits."""
    (jcfg, jp), (tcfg, tp) = _models(attn_impl="ring")
    tokens = _tokens()[:, :16]
    ref = jneox.forward(jp, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got = tneox.forward(tp, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ decode


def _decode_models(shape="d16", **over):
    (jcfg, jp), (tcfg, tp) = _models(shape, **over)
    for t in tneox.leaves(tp):
        t.requires_grad_(False)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("shape", ["d16", "d96"])
def test_forward_decode_over_a_dense_cache_matches_jax(shape):
    """Feeds of 5, 1, 1 and 3 tokens over the dense cache."""
    jcfg, jp, tcfg, tp = _decode_models(shape)
    b = 3
    jc = jneox.init_kv_cache(jcfg, b, 32)
    tc = tneox.init_kv_cache(tcfg, b, 32)
    rng = np.random.default_rng(3)
    for width in (5, 1, 1, 3):
        tokens = rng.integers(0, 256, (b, width)).astype(np.int32)
        jl, jc = jneox.forward_decode(jp, jcfg, jnp.asarray(tokens), jc)
        tl, tc = tneox.forward_decode(tp, tcfg, torch.from_numpy(tokens), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", ["d16", "d96"])
@pytest.mark.parametrize("quantized", [False, True])
def test_generate_greedy_tokens_equal_jax(shape, quantized):
    """Greedy tokens over the dense cache, native or int8 (an int8 value
    whose x / scale lies within f32 noise of a rounding boundary may round
    the other way in one package: tokens, not logits, are compared there)."""
    jcfg, jp, tcfg, tp = _decode_models(shape, kv_cache_quantized=quantized)
    prompt = _tokens(4, b=2, s=9)
    ref = np.asarray(jneox.generate(jp, jcfg, jnp.asarray(prompt), 8))
    got = tneox.generate(tp, tcfg, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------------- checkpoints


def _states(shape="d16"):
    """The same train state in both packages (JAX's init, fresh moments)."""
    jcfg = jneox.config("tiny", dtype=jnp.float32, **SHAPES[shape])
    jopt = jtrainer.build_optimizer(3e-3, warmup_steps=2, total_steps=8)
    jstate = jtrainer.init_train_state(lambda: jneox.init(jax.random.PRNGKey(0), jcfg), jopt)
    tcfg = tneox.config("tiny", dtype="float32", **SHAPES[shape])
    params = gptneox_params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu")
    topt = ttrainer.build_optimizer(3e-3, warmup_steps=2, total_steps=8)
    return jstate, ttrainer.init_train_state(params, tneox.leaves(params), topt), (tcfg, topt)


def _as_f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def test_the_port_restores_what_jax_saved(tmp_path):
    """JAX saves a state whose moments differ from each other; the port
    restores every member into the leaf at its position."""
    jstate, tstate, _ = _states()
    jstate = jtrainer.TrainState(
        jstate.params,
        jax.tree.map(lambda x: x + np.float32(0.25) if x.dtype == jnp.float32 else x + 3,
                     jstate.opt_state),
        jnp.asarray(5, jnp.int32))
    jck.NpzCheckpointer(str(tmp_path)).save(jstate, step=5)
    tck.NpzCheckpointer(str(tmp_path)).restore(tstate)
    ref = jax.tree_util.tree_leaves(jstate)
    got = tck.state_leaves(tstate)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(_as_f32(g), np.asarray(r, np.float32), err_msg=f"leaf {i}")
    assert tstate.step == 5 and tstate.opt_state.count == 3


def test_jax_restores_what_the_port_saved(tmp_path):
    jstate, tstate, (tcfg, topt) = _states("d96")
    step = ttrainer.make_train_step(lambda p, b: tneox.loss_fn(p, tcfg, b), topt)
    for seed in (0, 1):
        batch = np.random.default_rng(seed).integers(0, 256, (2, 33)).astype(np.int32)
        tstate, _ = step(tstate, {"tokens": torch.from_numpy(batch)})
    tck.NpzCheckpointer(str(tmp_path)).save(tstate)
    restored = jck.NpzCheckpointer(str(tmp_path)).restore(jstate)
    ref = jax.tree_util.tree_leaves(restored)
    got = tck.state_leaves(tstate)
    assert len(got) == len(ref) and int(restored.step) == 2
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(np.asarray(r, np.float32), _as_f32(g), err_msg=f"leaf {i}")


# ------------------------------------------------------------- entry points


_F32 = {"family": "gptneox", "preset": "tiny", "overrides": {"dtype": "float32"}}


def _spec(mode, ck_dir, steps=2, **extra):
    spec = {"kind": "jax_xla", "mode": mode, "model": _F32,
            "train": {"batchSize": 2, "seqLen": 32, "steps": steps, "learningRate": 3e-3,
                      "seed": 0},
            "checkpoint": {"enabled": True, "directory": str(ck_dir), "format": "npz",
                           "intervalSteps": 100, "keep": 2}}
    spec.update(extra)
    return spec


def _jax_run(spec):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX training run of 2 steps saved in npz: the weights both
    packages' entry points then start from."""
    ck = tmp_path_factory.mktemp("gptneox-ck")
    _jax_run(_spec("train", ck))
    return ck


def test_train_entry_resumes_and_matches_the_jax_entry(jax_checkpoint, tmp_path):
    import shutil

    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = tmp_path / who
        shutil.copytree(jax_checkpoint, dirs[who])
    ref = _jax_run(_spec("train", dirs["jax"], steps=4))
    got = run_template_runtime(_spec("train", dirs["port"], steps=4), device="cpu")
    assert got["resumed_from_step"] == ref["resumed_from_step"] == 2
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-5)
    np.testing.assert_allclose(got["final_loss"], ref["final_loss"], rtol=1e-5)
    assert got["param_count"] == ref["param_count"]
    assert set(got) - {"device", "device_kind"} == set(ref)


def test_infer_and_serve_entries_restore_and_match_the_jax_entry(jax_checkpoint):
    extra = {"infer": {"promptLength": 8, "maxNewTokens": 6, "iterations": 1}}
    ref = _jax_run(_spec("infer", jax_checkpoint, **extra))
    got = run_template_runtime(_spec("infer", jax_checkpoint, **extra), device="cpu")
    for key in ("weights_loaded", "restored_step", "batch_size", "prompt_len", "new_tokens"):
        assert got[key] == ref[key], key
    assert got["weights_loaded"] and got["last_logits_finite"]
    assert got["output_shape"] == [2, 8 + 6]
    extra = {"serve": {"numRequests": 5, "promptLengthMin": 4, "promptLengthMax": 30,
                       "maxNewMin": 3, "maxNewMax": 10, "sharedPrefixLength": 16,
                       "kvBlockSize": 8}}
    ref = _jax_run(_spec("serve", jax_checkpoint, **extra))
    got = run_template_runtime(_spec("serve", jax_checkpoint, **extra), device="cpu")
    for key in ("weights_loaded", "restored_step", "requests", "committed_tokens",
                "scheduled_step_slots", "decode_chunks", "insert_dispatches", "prefill_steps",
                "prefix_hit_tokens", "hydragen_waves", "kv_num_blocks",
                "kv_peak_allocated_blocks"):
        assert got[key] == ref[key], key
    assert got["ok_requests"] == 5 and got["budget_tokens"] == got["committed_tokens"]


def test_a_gptneox_spec_now_trains():
    """The spec that once raised 'not ported' (family gptneox, preset tiny)
    trains on the CPU: a finite loss and the LM metrics."""
    spec = {"kind": "jax_xla", "mode": "train", "model": {"family": "gptneox", "preset": "tiny"},
            "train": {"batchSize": 2, "seqLen": 64, "steps": 4, "learningRate": 3e-3}}
    m = run_template_runtime(spec, device="cpu")
    assert get_family("gptneox") is tneox
    assert m["family"] == "gptneox" and m["steps"] == 4
    assert np.isfinite(m["final_loss"]) and m["param_count"] == tneox.config("tiny").param_count()
