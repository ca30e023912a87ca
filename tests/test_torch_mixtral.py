"""The port's Mixtral (nexus_tpu_torch.models.mixtral) against the JAX
package's on the CPU, with the same weights carried across by
nexus_tpu_torch.interop.mixtral_params_from_jax.

Tiny model: 2 layers, d 64, 4 query / 2 kv heads, 4 experts top-2, V 256,
S 128, windows 0 and 48, both dispatches. Tolerances: f32 logits, loss
metrics and gradients rtol 1e-5 (atol 1e-6 on logits and metrics, 1e-7 on
gradients; the router's gradient, a sum over every token's routing
weights, rtol 1e-4); bf16 2e-2 of the reference's norm, each tensor as a
whole; greedy tokens and the serve ledger exactly equal in f32.

Routing is a discrete choice. In bf16 a token whose k-th and (k+1)-th
experts' probabilities lie within rounding of each other can be routed
otherwise by the two packages (XLA rounds a fused elementwise chain once,
eager PyTorch after every op), and that token's expert gradients then
differ by far more than rounding. Every case therefore first asserts that
both packages chose the same experts for every token of every layer (each
package's router logits recorded in the same call that is compared), so
the tolerance measures rounding and not a flipped choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import decoding as jdec
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.runtime import serving as jserving
from nexus_tpu_torch.interop import mixtral_params_from_jax
from nexus_tpu_torch.models import decoding as tdec
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime.entrypoints import resolve_overrides, run_template_runtime

SEQ = 128
METRICS = ("loss", "ce", "aux", "perplexity", "router_dropped_fraction")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch at these tiny
    shapes gains nothing from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(dtype="float32", **over):
    jcfg = jmix.config("tiny", dtype=getattr(jnp, dtype), **over)
    jparams = jmix.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tmix.config("tiny", dtype=dtype, **over)
    tparams = mixtral_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return (jcfg, jparams), (tcfg, tparams)


def _tokens(seed=0, b=2, s=SEQ + 1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _by_name(tree_of_arrays):
    out = {k: np.asarray(tree_of_arrays[k], np.float32) for k in ("embed", "final_norm",
                                                                  "lm_head")}
    out.update({f"layers/{k}": np.asarray(v, np.float32)
                for k, v in tree_of_arrays["layers"].items()})
    return out


def _port_grads(tparams, grads):
    names = ["embed"] + [f"layers/{k}" for k in tmix.LAYER_KEYS] + ["final_norm", "lm_head"]
    return {n: g.float().numpy() for n, g in zip(names, grads)}


def _near(got, ref, rel, name=""):
    """Each tensor as a whole: ||got - ref|| <= rel ||ref||."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.linalg.norm(got - ref)
    assert err <= rel * np.linalg.norm(ref), f"{name}: {err / np.linalg.norm(ref):.3g} > {rel}"


CASES = [("float32", 0, "scatter"), ("float32", 48, "einsum"), ("float32", 48, "scatter"),
         ("bfloat16", 0, "scatter"), ("bfloat16", 48, "einsum")]


@pytest.fixture
def routing(monkeypatch):
    """Records the router logits of every layer both packages route, in
    call order: {'jax': [...], 'port': [...]}; ``same()`` asserts that
    every token went to the same experts in both."""
    rec = {"jax": [], "port": []}
    j_orig, t_orig = jmix.top_k_routing, tmix.top_k_routing

    def j_wrapped(logits, k, cap):
        jax.debug.callback(lambda x: rec["jax"].append(np.asarray(x)), logits)
        return j_orig(logits, k, cap)

    def t_wrapped(logits, k, cap, dense=True):
        rec["port"].append(logits.detach().float().numpy())
        return t_orig(logits, k, cap, dense=dense)

    monkeypatch.setattr(jmix, "top_k_routing", j_wrapped)
    monkeypatch.setattr(tmix, "top_k_routing", t_wrapped)

    def same(k=2):
        assert len(rec["jax"]) == len(rec["port"]) > 0
        for layer, (a, b) in enumerate(zip(rec["jax"], rec["port"])):
            ja = np.sort(np.argsort(-a, axis=1, kind="stable")[:, :k], axis=1)
            tb = np.sort(np.argsort(-b, axis=1, kind="stable")[:, :k], axis=1)
            flipped = np.flatnonzero((ja != tb).any(1))
            assert flipped.size == 0, f"call {layer}: tokens {flipped} routed otherwise"
        rec["jax"].clear()
        rec["port"].clear()

    rec["same"] = same
    return rec


@pytest.mark.parametrize("dtype,window,dispatch", CASES)
def test_forward_and_loss_metrics_match_jax(dtype, window, dispatch, routing):
    over = dict(sliding_window=window, dispatch_impl=dispatch, attn_impl="xla")
    (jcfg, jp), (tcfg, tp) = _models(dtype, **over)
    tokens = _tokens()
    t = torch.from_numpy(tokens)
    ref_logits, ref_aux = jmix.forward(jp, jcfg, jnp.asarray(tokens[:, :-1]))
    with torch.no_grad():
        logits, aux = tmix.forward(tp, tcfg, t[:, :-1])
    routing["same"]()
    _, ref_m = jmix.loss_fn(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        _, m = tmix.loss_fn(tp, tcfg, {"tokens": t})
    routing["same"]()
    assert logits.dtype == torch.float32 and logits.shape == (2, SEQ, 256)
    assert set(m) == set(ref_m) == set(METRICS)
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
        for k in METRICS:
            np.testing.assert_allclose(m[k].item(), float(ref_m[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5)
    else:
        _near(logits.numpy(), ref_logits, 2e-2, "logits")
        for k in METRICS:
            _near(m[k].item(), float(ref_m[k]), 2e-2, k)
    assert 0.0 <= m["router_dropped_fraction"].item() < 1.0


@pytest.mark.parametrize("dtype,window,dispatch", CASES)
def test_parameter_gradients_match_jax(dtype, window, dispatch, routing):
    over = dict(sliding_window=window, dispatch_impl=dispatch, attn_impl="xla")
    (jcfg, jp), (tcfg, tp) = _models(dtype, **over)
    tokens = _tokens()
    jgrads = jax.grad(lambda p: jmix.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(jp)
    loss, _ = tmix.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    got = _port_grads(tp, torch.autograd.grad(loss, tmix.leaves(tp)))
    routing["same"]()
    ref = _by_name(jgrads)
    assert got.keys() == ref.keys()
    assert tp["layers"]["router"].dtype == torch.float32  # f32 in either dtype
    for name in ref:
        if dtype == "float32":
            rtol = 1e-4 if name == "layers/router" else 1e-5
            np.testing.assert_allclose(got[name], ref[name], rtol=rtol, atol=1e-7, err_msg=name)
        else:
            _near(got[name], ref[name], 2e-2, name)


def test_the_flash_path_with_a_window_matches_jax():
    """attn_impl 'flash': the JAX Pallas kernels in interpret mode against
    the port's flash path through its kernels' plain versions."""
    over = dict(sliding_window=48, dispatch_impl="scatter", attn_impl="flash")
    (jcfg, jp), (tcfg, tp) = _models(**over)
    tokens = _tokens(2)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmix.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(jp)
    loss, _ = tmix.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    got = _port_grads(tp, torch.autograd.grad(loss, tmix.leaves(tp)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, ref in _by_name(jgrads).items():
        rtol = 1e-4 if name == "layers/router" else 1e-5
        np.testing.assert_allclose(got[name], ref, rtol=rtol, atol=1e-7, err_msg=name)


def test_config_presets_and_param_counts_match_jax():
    for name, preset in jmix.PRESETS.items():
        assert tmix.PRESETS[name] == preset
        j, t = jmix.config(name), tmix.config(name)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert tmix.config("8x7b").param_count() == 46702792704  # Mixtral-8x7B's 46.7 B
    cfg = tmix.config("tiny", dtype="bfloat16")
    assert cfg.dtype == torch.bfloat16 and cfg.dispatch_impl == "auto"


def test_init_scales_layout_and_one_slice_at_a_time():
    """Shapes and dtypes of the JAX init, the same scale per tensor (std
    within 10%), norms exactly ones, the router f32 in a bf16 model."""
    jcfg = jmix.config("tiny", dtype=jnp.bfloat16)
    jparams = jmix.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tmix.config("tiny", dtype="bfloat16")
    tp = tmix.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    got = _port_grads(tp, [p.detach() for p in tmix.leaves(tp)])
    for name, ref in _by_name(jparams).items():
        assert got[name].shape == ref.shape, name
        if "ln_" in name or name == "final_norm":
            assert np.all(got[name] == 1.0), name
        else:
            np.testing.assert_allclose(got[name].std(), ref.std(), rtol=0.1, err_msg=name)
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w_gate"].dtype == torch.bfloat16
    assert tcfg.param_count() == sum(p.numel() for p in tmix.leaves(tp))
    # every expert of every layer is its own draw
    wg = tp["layers"]["w_gate"].float()
    assert not torch.equal(wg[0, 0], wg[0, 1]) and not torch.equal(wg[0, 0], wg[1, 0])


def test_the_entry_point_resolves_auto_dispatch_to_scatter_unless_pinned():
    """One rule for the entry point and the profiling tools: Mixtral's
    'auto' is the scatter dispatch on the port's one device (the JAX
    entry point's rule for a one-device mesh); a pinned value wins, other
    families get no dispatch, and train.remat folds in."""
    assert resolve_overrides("mixtral", {"n_layers": 1}) == {"n_layers": 1,
                                                             "dispatch_impl": "scatter"}
    assert resolve_overrides("mixtral", {"dispatch_impl": "einsum"}) == {
        "dispatch_impl": "einsum"}
    assert resolve_overrides("llama", {}, remat=True) == {"remat": True}
    assert resolve_overrides("llama", {"remat": False}, remat=True) == {"remat": False}


def test_interop_rejects_a_tree_of_another_config():
    (_, jp), _ = _models()
    cfg = tmix.config("tiny", dtype="float32", n_experts=8)
    with pytest.raises(ValueError, match="router"):
        mixtral_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def test_ring_attention_names_its_roadmap_item():
    _, (tcfg, tp) = _models(attn_impl="ring")
    with pytest.raises(NotImplementedError, match="item 4"):
        tmix.forward(tp, tcfg, torch.from_numpy(_tokens()[:, :16]))


# ------------------------------------------------------------------ decode


def _decode_models(dispatch):
    (jcfg, jp), (tcfg, tp) = _models(dispatch_impl=dispatch, sliding_window=6)
    for t in tmix.leaves(tp):
        t.requires_grad_(False)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("layout", ["dense", "paged", "fused"])
def test_forward_decode_logits_match_jax(layout, dispatch):
    """Feeds of 5, 1, 1 and 3 tokens (window 6) over the dense cache and a
    paged pool read through the gather and fused paths; routing and
    capacity span each feed's tokens."""
    jcfg, jp, tcfg, tp = _decode_models(dispatch)
    b, hkv, hd = 3, tcfg.n_kv_heads, tcfg.head_dim
    if layout == "dense":
        jc = jdec.init_kv_cache(2, hkv, hd, jnp.float32, b, 32)
        tc = tdec.init_kv_cache(2, hkv, hd, torch.float32, b, 32)
    else:
        jc = jdec.init_paged_kv_cache(2, hkv, hd, jnp.float32, b, 11, 4, 5)
        tc = tdec.init_paged_kv_cache(2, hkv, hd, torch.float32, b, 11, 4, 5)
        table = np.array([[3, 7, 1, 10, 10], [0, 9, 4, 2, 10], [6, 5, 8, 10, 10]], np.int32)
        jc["block_table"], tc["block_table"] = jnp.asarray(table), torch.from_numpy(table)
    rng = np.random.default_rng(3)
    for width in (5, 1, 1, 3):
        tokens = rng.integers(0, 256, (b, width)).astype(np.int32)
        jin, tin = dict(jc), dict(tc)
        if layout == "fused":
            jin["shared_blocks"], tin["shared_blocks"] = jnp.asarray(0, jnp.int32), torch.tensor(0)
            jin["shared_table"] = jnp.full((5,), 10, jnp.int32)
            tin["shared_table"] = torch.full((5,), 10, dtype=torch.int32)
        jl, jc = jmix.forward_decode(jp, jcfg, jnp.asarray(tokens), jin)
        tl, tc = tmix.forward_decode(tp, tcfg, torch.from_numpy(tokens), tin)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_generate_greedy_tokens_equal_jax():
    jcfg, jp, tcfg, tp = _decode_models("scatter")
    prompt = _tokens(4, b=2, s=9)
    ref = np.asarray(jmix.generate(jp, jcfg, jnp.asarray(prompt), 8))
    got = tmix.generate(tp, tcfg, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def _queue():
    rng = np.random.RandomState(23)
    common = rng.randint(0, 256, size=16).tolist()
    q = [(common + rng.randint(0, 256, size=p).tolist(), n) for p, n in ((8, 6), (5, 5), (12, 7))]
    q.append((list(q[0][0]), 4))  # a block-aligned duplicate: a copy-on-write hit
    q.append((rng.randint(0, 256, size=7).tolist(), 6))
    return q


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_tokens_and_ledger_equal_the_jax_engine(prefix_cache):
    jcfg, jp, tcfg, tp = _decode_models("scatter")
    kw = dict(batch_size=2, max_len=64, chunk=4, prefill_chunk=3, kv_block_size=8,
              prefix_cache=prefix_cache, attention_path="fused")
    q = _queue()
    jres, jmet = jserving.ServingEngine(jmix.forward_decode, jp, jcfg, **kw).serve(
        [jserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    tres, tmet = tserving.ServingEngine(tmix.forward_decode, tp, tcfg, **kw).serve(
        [tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    for a, b in zip(tres, jres):
        assert a.tokens == [int(x) for x in b.tokens]
        assert (a.new_tokens, a.status) == (b.new_tokens, b.status)
    common = [k for k in jmet if k in tmet and k not in ("wall_s", "tokens_per_sec")
              and not k.endswith("_s")]
    assert {k: tmet[k] for k in common} == {k: jmet[k] for k in common}
    assert tmet["committed_tokens"] == sum(n for _, n in q)
    if prefix_cache:
        assert tmet["prefix_hit_tokens"] > 0 and tmet["hydragen_waves"] >= 1


# ------------------------------------------------------------- entry points

_F32 = {"family": "mixtral", "preset": "tiny", "overrides": {"dtype": "float32"}}


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
    ck = tmp_path_factory.mktemp("mixtral-ck")
    _jax_run(_spec("train", ck))
    return ck


def test_train_entry_resumes_and_matches_the_jax_entry(jax_checkpoint, tmp_path):
    """Both entry points resume the JAX run's step 2 and train to step 4 on
    the same batches: the same dispatch, loss history and final loss."""
    import shutil

    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = tmp_path / who
        shutil.copytree(jax_checkpoint, dirs[who])
    ref = _jax_run(_spec("train", dirs["jax"], steps=4))
    got = run_template_runtime(_spec("train", dirs["port"], steps=4), device="cpu")
    assert got["moe_dispatch"] == ref["moe_dispatch"] == "scatter"
    assert got["resumed_from_step"] == ref["resumed_from_step"] == 2
    assert got["checkpoint_saved"] and ref["checkpoint_saved"]
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-5)
    np.testing.assert_allclose(got["final_loss"], ref["final_loss"], rtol=1e-5)
    assert got["param_count"] == ref["param_count"]


def test_infer_entry_restores_and_matches_the_jax_entry(jax_checkpoint):
    extra = {"infer": {"promptLength": 8, "maxNewTokens": 6, "iterations": 1}}
    ref = _jax_run(_spec("infer", jax_checkpoint, **extra))
    got = run_template_runtime(_spec("infer", jax_checkpoint, **extra), device="cpu")
    for key in ("weights_loaded", "restored_step", "batch_size", "prompt_len", "new_tokens"):
        assert got[key] == ref[key], key
    assert got["weights_loaded"] and got["restored_step"] == 2 and got["last_logits_finite"]
    assert got["output_shape"] == [2, 8 + 6]


def test_serve_entry_restores_and_matches_the_jax_ledger(jax_checkpoint):
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
