"""Speculation in the port (models/decoding.py, the serving engine's lookup
and draft tiers, the infer and serve entry points) against the JAX
package's, on the CPU in float32: the tiny Llama preset with seeded
weights carried across by ``interop.llama_params_from_jax``, inputs made
with numpy.

Exact throughout: the acceptance helpers and the n-gram proposer equal
JAX's integer for integer; greedy speculative decoding equals JAX's tokens
and plain greedy (the tiny model's top-2 logit gaps on these prompts are
far above float32 noise); the engine's tiers equal the JAX engine's tokens
and its clock-free speculation ledger. The rejection-sampling step takes
torch's generator for its one draw, so its accepted counts and tokens are
compared for the same uniforms, and its residual distribution to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import decoding as jdec
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import serving as jserving
from nexus_tpu_torch.api import runtime_spec as tspec
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import decoding as tdec
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.runtime import serving as tserving


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch at these tiny shapes
    gains nothing from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed=0, int8=False):
    jcfg = jllama.config("tiny", dtype=jnp.float32, kv_cache_quantized=int8)
    jparams = jllama.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = tllama.config("tiny", dtype="float32", kv_cache_quantized=int8)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    return (jcfg, jparams), (tcfg, tparams)


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------ the pure helpers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_accept_and_commit_equal_jax(seed):
    rng = np.random.default_rng(seed)
    b, k, v, max_len = 6, 4, 5, 20
    proposals = rng.integers(0, v, (b, k)).astype(np.int32)
    choice = rng.integers(0, v, (b, k + 1)).astype(np.int32)
    choice[0, :k] = proposals[0]  # a fully accepted row
    choice[1, :2] = proposals[1, :2]
    ja, jo = jdec._greedy_accept(jnp.asarray(proposals), jnp.asarray(choice))
    ta, to = tdec._greedy_accept(torch.from_numpy(proposals), torch.from_numpy(choice))
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
    np.testing.assert_array_equal(to.numpy(), _np(jo))

    buf = rng.integers(0, v, (b, max_len)).astype(np.int32)
    last_pos = np.array([3, 7, 14, 17, 19, 5], np.int32)  # rows whose window runs off the end
    active = np.array([True, True, False, True, True, True])
    cache_len = rng.integers(0, max_len, b).astype(np.int32)
    jb, jn, jl = jdec._commit_speculation(
        jnp.asarray(buf), jnp.arange(b), jnp.asarray(last_pos), jnp.asarray(active), ja, jo, k,
        max_len, jnp.asarray(cache_len))
    tb, tn, tl = tdec._commit_speculation(
        torch.from_numpy(buf), torch.from_numpy(last_pos), torch.from_numpy(active), ta, to, k,
        torch.from_numpy(cache_len))
    np.testing.assert_array_equal(tb.numpy(), _np(jb))
    np.testing.assert_array_equal(tn.numpy(), _np(jn))
    np.testing.assert_array_equal(tl.numpy(), _np(jl))
    assert tl.dtype == torch.int32


@pytest.mark.parametrize("ngram,k", [(1, 3), (2, 4), (3, 2), (30, 3)])
def test_prompt_lookup_propose_equals_jax(ngram, k):
    """Small vocab (many matches), latest match wins, self-match excluded,
    continuations running into scratch, and an n-gram as wide as the
    buffer (no window fits)."""
    rng = np.random.default_rng(ngram)
    b, max_len = 5, 24 if ngram < 30 else 30
    buf = rng.integers(0, 4, (b, max_len)).astype(np.int32)
    last_pos = np.array([0, 5, 11, 20, max_len - 1], np.int32)
    jp, jf = jdec.prompt_lookup_propose(jnp.asarray(buf), jnp.asarray(last_pos), k, ngram)
    tp, tf = tdec.prompt_lookup_propose(torch.from_numpy(buf), torch.from_numpy(last_pos), k,
                                        ngram)
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(tf.numpy(), _np(jf))
    if ngram < 30:
        assert tf.any() and not tf.all()


def _probs(rng, shape):
    x = rng.random(shape).astype(np.float32) ** 3 + 1e-3
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_speculative_accept_step_equals_jax_for_the_same_uniforms(seed, monkeypatch):
    """Per row, the same accepted count and accepted tokens as JAX's step
    for the same uniforms, and the same distribution for the drawn token
    (JAX's own, caught at its jax.random.choice call) to 1e-6."""
    rng = np.random.default_rng(seed)
    b, k, v = 6, 3, 7
    q = _probs(rng, (b, k, v))
    p = _probs(rng, (b, k + 1, v))
    props = rng.integers(0, v, (b, k)).astype(np.int32)
    p[1, np.arange(k), props[1]] = 5.0  # row 1 accepts everything: the bonus draw
    p = p / p.sum(-1, keepdims=True)
    q[2] = p[2, :k]  # row 2: draft == target, every residual empty
    u = rng.random((b, k)).astype(np.float32)
    u[3] = 0.999

    seen = []
    real_choice = jax.random.choice

    def catch(key, n, p=None, **kw):
        seen.append(np.asarray(p))
        return real_choice(key, n, p=p, **kw)

    monkeypatch.setattr(jax.random, "choice", catch)
    gen = torch.Generator().manual_seed(seed)
    ta, to = tdec.speculative_accept_step(torch.from_numpy(q), torch.from_numpy(p),
                                          torch.from_numpy(props), torch.from_numpy(u), gen)
    tdist = tdec._correction_distribution(torch.from_numpy(q), torch.from_numpy(p), ta)
    for r in range(b):
        seen.clear()
        ja, jo = jdec.speculative_accept_step(jnp.asarray(q[r]), jnp.asarray(p[r]),
                                              jnp.asarray(props[r]), jnp.asarray(u[r]),
                                              jax.random.PRNGKey(r))
        a = int(ja)
        assert int(ta[r]) == a, r
        np.testing.assert_array_equal(to[r, :a].numpy(), _np(jo)[:a])
        assert (to[r, a + 1:] == 0).all() and 0 <= int(to[r, a]) < v
        assert len(seen) == 1
        np.testing.assert_allclose(tdist[r].numpy(), seen[0], rtol=0, atol=1e-6)
    assert int(ta[1]) == k


def test_speculative_accept_step_draws_from_the_correction_distribution():
    """The drawn token follows ``_correction_distribution`` (4000 draws of
    one rejected row, within 4 standard errors)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_probs(rng, (1, 2, 5)))
    p = torch.from_numpy(_probs(rng, (1, 3, 5)))
    props = torch.tensor([[int(torch.argmax(q[0, 0] - p[0, 0]))] * 2])
    u = torch.tensor([[0.9999, 0.5]])
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = torch.stack([tdec.speculative_accept_step(q, p, props, u, gen)[1][0, 0]
                         for _ in range(n)])
    dist = tdec._correction_distribution(q, p, torch.zeros(1, dtype=torch.long))[0].double()
    freq = torch.bincount(draws.long(), minlength=5).double() / n
    se = torch.sqrt(dist * (1 - dist) / n)
    assert torch.all((freq - dist).abs() <= 4 * se + 1e-9), (freq, dist)


# ------------------------------------------------------ the dense loops


def _prompts(vocab, b=2, p=9, seed=4, repeat=False):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, vocab, size=(b, p)).astype(np.int32)
    if repeat:  # self-repetitive prompts: n-gram lookups hit
        x[:, p // 2:] = x[:, : p - p // 2]
    return x


@pytest.mark.parametrize("ngram,k,repeat", [(2, 3, False), (2, 4, True), (1, 2, True)])
def test_prompt_lookup_generate_equals_jax_and_plain_greedy(ngram, k, repeat):
    (jcfg, jparams), (tcfg, tparams) = _models()
    prompt = _prompts(jcfg.vocab_size, b=3, p=10, repeat=repeat)
    n = 9
    jt, js = jdec.prompt_lookup_generate(jllama.forward_decode, jparams, jcfg,
                                         jnp.asarray(prompt), n, num_speculative=k, ngram=ngram)
    tt, ts = tdec.prompt_lookup_generate(tllama.forward_decode, tparams, tcfg,
                                         torch.from_numpy(prompt), n, num_speculative=k,
                                         ngram=ngram)
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    assert ts == {key: int(val) for key, val in js.items()}
    plain = tllama.generate(tparams, tcfg, torch.from_numpy(prompt), n)
    np.testing.assert_array_equal(tt.numpy(), plain.numpy())


@pytest.mark.parametrize("draft_seed,int8", [(0, False), (9, False), (9, True)])
def test_speculative_generate_greedy_equals_jax_and_plain_greedy(draft_seed, int8):
    """A self-draft (near-total acceptance), an unrelated draft (rejection
    heavy), and int8 dense caches."""
    (jcfg, jparams), (tcfg, tparams) = _models(int8=int8)
    (_, jdraft), (_, tdraft) = _models(seed=draft_seed, int8=int8)
    prompt = _prompts(jcfg.vocab_size, b=3, p=7, seed=6)
    n = 8
    jt, js = jdec.speculative_generate(jllama.forward_decode, jparams, jcfg,
                                       jllama.forward_decode, jdraft, jcfg, jnp.asarray(prompt),
                                       n, num_speculative=3)
    tt, ts = tdec.speculative_generate(tllama.forward_decode, tparams, tcfg,
                                       tllama.forward_decode, tdraft, tcfg,
                                       torch.from_numpy(prompt), n, num_speculative=3)
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    assert ts == {key: int(val) for key, val in js.items()}
    plain = tllama.generate(tparams, tcfg, torch.from_numpy(prompt), n)
    np.testing.assert_array_equal(tt.numpy(), plain.numpy())
    if draft_seed == 0:
        assert ts["accepted"] == ts["drafted"]


def test_sampled_speculative_generate_is_reproducible_from_its_generator():
    _, (cfg, params) = _models()
    _, (_, draft) = _models(seed=9)
    prompt = torch.from_numpy(_prompts(cfg.vocab_size, b=2, p=6))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tdec.speculative_generate(tllama.forward_decode, params, cfg,
                                         tllama.forward_decode, draft, cfg, prompt, 10,
                                         num_speculative=3, temperature=0.8, generator=gen)

    a, sa = run(1)
    b, _ = run(1)
    assert torch.equal(a, b) and a.shape == (2, 16) and sa["rounds"] >= 1
    assert not torch.equal(a, run(2)[0])
    assert torch.equal(a[:, :6], prompt)
    with pytest.raises(ValueError, match="Generator"):
        tdec.speculative_generate(tllama.forward_decode, params, cfg, tllama.forward_decode,
                                  draft, cfg, prompt, 4, temperature=0.5)


@pytest.mark.parametrize("kw,match", [(dict(num_speculative=0), "num_speculative"),
                                      (dict(ngram=0), "ngram"),
                                      (dict(max_len=12), "cache slots")])
def test_prompt_lookup_generate_rejects_what_jax_rejects(kw, match):
    _, (cfg, params) = _models()
    prompt = torch.from_numpy(_prompts(cfg.vocab_size, b=1, p=5))
    with pytest.raises(ValueError, match=match):
        tdec.prompt_lookup_generate(tllama.forward_decode, params, cfg, prompt, 6, **kw)


# ------------------------------------------------------ the serving engine

# the JAX engine's metric keys that read a clock
CLOCKED = ("wall_s", "tokens_per_sec", "traced", "flight_recorder_events", "flight_dumps",
           "live_gauge_publishes")
SPEC_KEYS = ("speculative_kind", "num_speculative", "target_forwards", "acceptance_rate",
             "accepted_per_round", "decode_dispatches_per_committed_token")


def _queue(vocab):
    """A shared 16-token preamble under three requests (prefix hits), a
    block-aligned duplicate (copy-on-write), a self-repetitive prompt
    (n-gram hits) and an unshared control."""
    rng = np.random.RandomState(23)
    common = rng.randint(0, vocab, size=16).tolist()
    q = [(common + rng.randint(0, vocab, size=p).tolist(), n) for p, n in ((8, 6), (5, 9), (12, 7))]
    q.append((list(q[0][0]), 5))
    rep = rng.randint(0, vocab, size=5).tolist()
    q.append((rep * 3, 8))
    q.append((rng.randint(0, vocab, size=7).tolist(), 6))
    return q


ENGINE_VARIANTS = [(path, pc, pool) for path in ("fused", "gather") for pc in (True, False)
                   for pool in ("native", "int8")] + [("dense", False, "native")]


def _both_engines(tier, path, prefix_cache, pool, **extra):
    (jcfg, jparams), (tcfg, tparams) = _models()
    kw = dict(batch_size=2, max_len=64, chunk=5, num_speculative=3, **extra)
    if path == "dense":
        kw["kv_block_size"] = 0
    else:
        kw.update(kv_block_size=8, prefix_cache=prefix_cache, attention_path=path,
                  kv_pool_dtype=pool)
    jkw, tkw = dict(kw), dict(kw)
    if tier == "lookup":
        jkw["lookup_ngram"] = tkw["lookup_ngram"] = 2
    else:  # an unrelated draft: acceptance well below 1, rollbacks every round
        (_, jdraft), (_, tdraft) = _models(seed=9)
        jkw.update(draft_forward=jllama.forward_decode, draft_params=jdraft, draft_cfg=jcfg)
        tkw.update(draft_forward=tllama.forward_decode, draft_params=tdraft, draft_cfg=tcfg)
    jeng = jserving.ServingEngine(jllama.forward_decode, jparams, jcfg, **jkw)
    teng = tserving.ServingEngine(tllama.forward_decode, tparams, tcfg, **tkw)
    return jeng, teng, tcfg, tparams


@pytest.mark.parametrize("tier", ["lookup", "draft"])
@pytest.mark.parametrize("path,prefix_cache,pool", ENGINE_VARIANTS)
def test_engine_tiers_match_the_jax_engine(tier, path, prefix_cache, pool):
    """Both tiers, over fused/gather x prefix cache on/off x native/int8
    and the dense layout:
    the JAX engine's tokens, its clock-free ledger and its speculation
    metrics, and plain greedy (an isolated ``generate``) per request."""
    jeng, teng, cfg, params = _both_engines(tier, path, prefix_cache, pool)
    q = _queue(cfg.vocab_size)
    jres, jmet = jeng.serve([jserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    tres, tmet = teng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    for a, b in zip(tres, jres):
        assert a.tokens == [int(x) for x in b.tokens]
        assert (a.new_tokens, a.status) == (b.new_tokens, b.status)
    common = [k for k in jmet if k in tmet and k not in CLOCKED and not k.endswith("_s")]
    assert set(SPEC_KEYS) <= set(common)
    assert {k: tmet[k] for k in common} == {k: jmet[k] for k in common}
    assert tmet["target_forwards"] > 0 and tmet.get("kv_allocated_blocks_final", 0) == 0
    if prefix_cache:
        assert tmet["prefix_hit_tokens"] > 0
    if pool == "native" and path == "fused":  # float32 weights: plain greedy, exactly
        for (p, n), res in zip(q, tres):
            ref = tllama.generate(params, cfg, torch.tensor([p], dtype=torch.int32), n)
            assert res.tokens == ref[0].tolist()


def test_self_draft_accepts_nearly_everything():
    """A draft that IS the target, prefilling in lockstep (prefix cache
    off), proposes the target's own choices: acceptance near 1, well under
    one target forward a committed token; tokens equal plain greedy."""
    _, (cfg, params) = _models()
    q = _queue(cfg.vocab_size)
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=2, max_len=64,
                                 chunk=5, num_speculative=3, kv_block_size=8, prefix_cache=False,
                                 draft_forward=tllama.forward_decode, draft_params=params,
                                 draft_cfg=cfg)
    res, m = eng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    assert m["speculative_kind"] == "draft_model"
    assert m["acceptance_rate"] > 0.9 and m["decode_dispatches_per_committed_token"] < 0.6, m
    for (p, n), r in zip(q, res):
        assert r.tokens == tllama.generate(params, cfg, torch.tensor([p], dtype=torch.int32),
                                           n)[0].tolist()


def test_rollback_never_publishes_multi_turn_exact():
    """Turn-1 requests run rejection-heavy lookup speculation (verify
    windows write rejected K/V into tail blocks before rolling back), their
    completions enter the radix tree at release, and turn-2 requests that
    extend them hit those blocks: had a partly rejected block been
    published, the successors would read stale K/V and part from greedy."""
    _, (cfg, params) = _models()
    rng = np.random.RandomState(13)

    def engine():
        return tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=2,
                                      max_len=64, chunk=5, lookup_ngram=2, num_speculative=3,
                                      kv_block_size=4, prefix_cache=True)

    turn1 = [tserving.ServeRequest(prompt=rng.randint(0, cfg.vocab_size, size=9).tolist(),
                                   max_new_tokens=12) for _ in range(2)]
    r1, _ = engine().serve(turn1)
    turn2 = [tserving.ServeRequest(prompt=list(r.tokens) + rng.randint(0, cfg.vocab_size,
                                                                       size=3).tolist(),
                                   max_new_tokens=6) for r in r1]
    eng = engine()
    results, m = eng.serve(turn1 + turn2)
    eng.last_prefix_index.audit()
    assert m["prefix_completion_blocks"] > 0 and m["prefix_hit_tokens"] > 0, m
    for req, res in zip(turn1 + turn2, results):
        ref = tllama.generate(params, cfg, torch.tensor([req.prompt], dtype=torch.int32),
                              res.new_tokens)
        assert res.tokens == ref[0].tolist()


@pytest.mark.parametrize("kw,draft,match", [
    (dict(lookup_ngram=2), dict(), "mutually exclusive"),
    (dict(), dict(preset="draft"), "share the target vocab"),
    (dict(), dict(max_seq_len=32), "cover the serve context"),
    (dict(lookup_ngram=2, num_speculative=0), None, "num_speculative"),
])
def test_engine_refuses_what_the_jax_engine_refuses(kw, draft, match):
    _, (cfg, params) = _models()
    base = dict(batch_size=1, max_len=64, kv_block_size=8)
    args = dict(base, **kw)
    if draft is not None:
        dcfg = tllama.config(draft.get("preset", "tiny"), dtype="float32",
                             max_seq_len=draft.get("max_seq_len", 512))
        args.update(draft_forward=tllama.forward_decode, draft_params=params, draft_cfg=dcfg)
    with pytest.raises(ValueError, match=match):
        tserving.ServingEngine(tllama.forward_decode, params, cfg, **args)
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, lookup_ngram=2, **base)
    with pytest.raises(ValueError, match="greedy-exact only"):
        eng.serve([tserving.ServeRequest(prompt=[1, 2, 3], max_new_tokens=4, temperature=0.5)])


# ------------------------------------------------------ spec and entry points

_TINY = {"family": "llama", "preset": "tiny"}
_DRAFT_8B_VOCAB = {"family": "llama", "preset": "draft"}  # vocab 32000: not tiny's


@pytest.mark.parametrize("mode,block,needle", [
    ("serve", {"promptLookupNgram": 2, "draft": _TINY}, "mutually exclusive"),
    ("serve", {"promptLookupNgram": 2, "temperature": 0.5}, "greedy-exact"),
    ("serve", {"promptLookupNgram": 2, "numSpeculative": 0}, "numSpeculative"),
    ("serve", {"draft": _DRAFT_8B_VOCAB}, "share the target vocab"),
    ("serve", {"draft": dict(_TINY, overrides={"max_seq_len": 128})}, "cover the serve context"),
    ("serve", {"draft": {"family": "mlp", "preset": "tiny"}}, "LM family"),
    ("serve", {"promptLookupNgram": 2, "numSpeculative": 100, "chunk": 8,
               "promptLengthMax": 16, "maxNewMax": 8, "kvBlockSize": 64}, "window too large"),
    ("infer", {"promptLookupNgram": 2, "draft": _TINY}, "mutually exclusive"),
    ("infer", {"promptLookupNgram": 2, "temperature": 0.5}, "temperature == 0"),
    ("infer", {"promptLookupNgram": 2, "numSpeculative": 0}, "numSpeculative"),
    ("infer", {"draft": _DRAFT_8B_VOCAB}, "share the target vocab"),
])
def test_validate_reports_the_jax_speculation_errors(mode, block, needle):
    spec = {"mode": mode, "model": _TINY, mode: block}
    errs = tspec.JaxXlaRuntime.from_dict(spec).validate()
    jerrs = jspec.JaxXlaRuntime.from_dict(spec).validate()
    assert any(needle in e for e in jerrs), jerrs
    mine = [e for e in errs if needle in e]
    assert mine and all(e in jerrs for e in mine), (errs, jerrs)


@pytest.mark.parametrize("serve", [{"prefillChunk": 17}, {"prefillChunk": 32},
                                   {"prefillChunk": 64},
                                   {"promptLookupNgram": 2, "numSpeculative": 16},
                                   {"draft": _TINY, "numSpeculative": 31},
                                   {"promptLookupNgram": 3, "numSpeculative": 63}])
def test_validate_accepts_the_wide_feeds_jax_serves(serve):
    """Feeds of 17, 32 and 64 tokens (prefill chunks, verify windows of
    numSpeculative + 1) are valid specs, as in JAX: the paged-decode kernel
    takes them."""
    spec = {"mode": "serve", "model": _TINY, "serve": serve}
    one_chip = {"accelerator": "v5e", "topology": "1x1"}  # the JAX spec's chip count
    assert jspec.JaxXlaRuntime.from_dict(dict(spec, tpu=one_chip)).validate() == []
    assert tspec.JaxXlaRuntime.from_dict(spec).validate() == []


def _jax_run(spec):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(
        dict(spec, tpu={"accelerator": "v5e", "topology": "1x1"})))


_INFER = {"mode": "infer", "model": _TINY, "train": {"batchSize": 2, "seed": 0},
          "infer": {"promptTokenIds": [3, 4, 5, 3, 4, 5, 3, 4], "maxNewTokens": 10,
                    "iterations": 1}}
_SERVE = {"mode": "serve", "model": _TINY, "train": {"batchSize": 2, "seed": 0},
          "serve": {"numRequests": 5, "promptLengthMin": 4, "promptLengthMax": 30,
                    "maxNewMin": 3, "maxNewMax": 10, "sharedPrefixLength": 16,
                    "kvBlockSize": 8}}


@pytest.mark.parametrize("mode,block", [
    ("infer", {"promptLookupNgram": 2, "numSpeculative": 3}),
    ("infer", {"draft": _TINY, "numSpeculative": 3}),
    ("infer", {"draft": _TINY, "numSpeculative": 2, "temperature": 0.7}),
    ("serve", {"promptLookupNgram": 2, "numSpeculative": 4}),
    ("serve", {"draft": dict(_TINY, overrides={"max_seq_len": 512}), "numSpeculative": 4}),
])
def test_speculative_entry_points_return_the_jax_metric_keys(mode, block):
    """Both tiers through ``run_template_runtime``: every metric key the JAX
    entry point reports, the speculation ledger among them (the two
    packages' random weights differ, so the values are checked for sense,
    not against JAX's)."""
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    base = _INFER if mode == "infer" else _SERVE
    spec = dict(base, **{mode: dict(base[mode], **block)})
    got = run_template_runtime(spec, device="cpu")
    ref = _jax_run(spec)
    assert set(ref) - set(got) == set()
    assert 0.0 <= got["acceptance_rate"] <= 1.0
    if mode == "infer":
        assert got["speculative"] and got["output_shape"] == [2, 18] and got["rounds"] >= 1
        assert "last_logits_finite" not in got
    else:
        assert got["speculative_kind"] == ref["speculative_kind"]
        assert got["target_forwards"] > 0 and got["ok_requests"] == 5
        assert got["committed_tokens"] == got["budget_tokens"] == ref["committed_tokens"]
        assert got["kv_allocated_blocks_final"] == 0
