"""The port's serving engine (nexus_tpu_torch.runtime.serving) against the
JAX package's, on the CPU in float32, with the same tiny Llama weights
carried across by interop.llama_params_from_jax (and, in
test_gptneox_engine_matches_the_jax_engine, GPT-NeoX's tiny preset's by
interop.gptneox_params_from_jax).

Exactness: the same queue — a shared 16-token preamble under three
requests, a block-aligned full duplicate (copy-on-write), an unshared
control — commits the same greedy tokens through both engines, and the
same clock-free ledger counts (committed tokens, step slots, chunks,
insert waves, prefill steps, prefix hits, CoW copies, Hydragen waves, pool
peaks and final partition, ...), over fused / gather / dense × prefix cache
on / off × native / int8 pools. Greedy ties cannot flip: the tiny model's
top-2 logit gaps on this queue are far above float32 noise (the tokens are
compared exactly). Sampled streams are held to the port's own rule —
deterministic, batch- and row-invariant, distributed as softmax(logits/T)
— since torch cannot reproduce JAX's threefry draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.models import gptneox as jneox
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import serving as jserving
from nexus_tpu_torch.interop import gptneox_params_from_jax, llama_params_from_jax
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime.traffic import ListSource

# every common metric key except the clocks
CLOCKED = ("wall_s", "tokens_per_sec")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on a few cores; torch at these
    tiny shapes gains nothing from threads, so keep it to one here rather
    than crowd out the other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(int8_cfg=False):
    jcfg = jllama.config("tiny", dtype=jnp.float32, kv_cache_quantized=int8_cfg)
    jparams = jllama.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.config("tiny", dtype="float32", kv_cache_quantized=int8_cfg)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    return (jcfg, jparams), (tcfg, tparams)


def _queue():
    rng = np.random.RandomState(23)
    common = rng.randint(0, 256, size=16).tolist()
    q = [(common + rng.randint(0, 256, size=p).tolist(), n) for p, n in ((8, 6), (5, 5), (12, 7))]
    q.append((list(q[0][0]), 4))  # 24 tokens = 3 full blocks: a CoW hit
    q.append((rng.randint(0, 256, size=7).tolist(), 6))
    return q


VARIANTS = [
    (path, pc, pool) for path in ("fused", "gather") for pc in (True, False)
    for pool in ("native", "int8")
] + [("dense", False, "native"), ("dense", False, "int8")]


def _neox_models(int8_cfg=False):
    """GPT-NeoX's tiny preset (4 heads of 16, MHA, partial rotary) in both
    packages, the same weights."""
    jcfg = jneox.config("tiny", dtype=jnp.float32, kv_cache_quantized=int8_cfg)
    jparams = jneox.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tneox.config("tiny", dtype="float32", kv_cache_quantized=int8_cfg)
    tparams = gptneox_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tneox.leaves(tparams):
        t.requires_grad_(False)
    return (jcfg, jparams), (tcfg, tparams)


FAMILIES = {"llama": (jllama, tllama, _models), "gptneox": (jneox, tneox, _neox_models)}


def _engines_agree(family, path, prefix_cache, pool):
    jfam, tfam, models = FAMILIES[family]
    dense = path == "dense"
    (jcfg, jparams), (tcfg, tparams) = models(int8_cfg=dense and pool == "int8")
    if dense:
        kw = dict(kv_block_size=0)
    else:
        kw = dict(kv_block_size=8, prefix_cache=prefix_cache, attention_path=path,
                  kv_pool_dtype=pool)
    q = _queue()
    jeng = jserving.ServingEngine(jfam.forward_decode, jparams, jcfg, batch_size=2,
                                  max_len=64, chunk=4, prefill_chunk=3, **kw)
    jres, jmet = jeng.serve([jserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    teng = tserving.ServingEngine(tfam.forward_decode, tparams, tcfg, batch_size=2,
                                  max_len=64, chunk=4, prefill_chunk=3, **kw)
    tres, tmet = teng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    for a, b in zip(tres, jres):
        assert a.tokens == [int(x) for x in b.tokens]
        assert (a.new_tokens, a.finished_by_stop, a.status) == (b.new_tokens,
                                                                 b.finished_by_stop, b.status)
    common = [k for k in jmet if k in tmet and k not in CLOCKED and not k.endswith("_s")]
    assert {k: tmet[k] for k in common} == {k: jmet[k] for k in common}
    for key in ("committed_tokens", "scheduled_step_slots", "decode_chunks",
                "insert_dispatches", "prefill_steps"):
        assert key in common
    if not dense:
        assert {"kv_peak_allocated_blocks", "kv_free_blocks_final", "kv_parked_blocks_final",
                "kv_allocated_blocks_final", "kv_reserved_blocks_final"} <= set(common)
        assert tmet["kv_allocated_blocks_final"] == tmet["kv_reserved_blocks_final"] == 0
    if prefix_cache:
        assert tmet["prefix_hit_tokens"] > 0 and tmet["prefix_cow_copies"] >= 1
    if path == "fused":
        assert "hydragen_waves" in common
        if prefix_cache:  # shared blocks exist only through the cache
            assert tmet["hydragen_waves"] >= 1


@pytest.mark.parametrize("path,prefix_cache,pool", VARIANTS)
def test_engine_matches_the_jax_engine(path, prefix_cache, pool):
    _engines_agree("llama", path, prefix_cache, pool)


@pytest.mark.parametrize("path,prefix_cache,pool", VARIANTS)
def test_gptneox_engine_matches_the_jax_engine(path, prefix_cache, pool):
    """The engine over GPT-NeoX's decode (the generic scaffold with the
    NeoX block and final LayerNorm; pool sized from n_kv_heads = n_heads
    and head dim 16): the JAX engine's tokens and ledger."""
    _engines_agree("gptneox", path, prefix_cache, pool)


def test_engine_matches_isolated_generate():
    _, (cfg, params) = _models()
    q = _queue()
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=2, max_len=64,
                                 chunk=4, prefill_chunk=3, kv_block_size=8)
    results, _ = eng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    for (p, n), res in zip(q, results):
        ref = tllama.generate(params, cfg, torch.tensor([p], dtype=torch.int32), n)
        assert res.tokens == ref[0].tolist()


def _sampled_queue():
    rng = np.random.RandomState(5)
    return [tserving.ServeRequest(prompt=rng.randint(0, 256, size=p).tolist(), max_new_tokens=n,
                                  temperature=t, seed=s)
            for p, n, t, s in ((6, 7, 0.8, 1), (9, 5, 0.0, 0), (4, 8, 1.2, 7), (11, 6, 0.5, 2))]


def _serve(params, cfg, queue, batch_size, **kw):
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=batch_size,
                                 max_len=64, chunk=3, prefill_chunk=4, kv_block_size=8, **kw)
    results, _ = eng.serve(queue)
    return [r.tokens for r in results]


def test_sampled_streams_are_deterministic_and_batch_and_row_invariant():
    _, (cfg, params) = _models()
    q = _sampled_queue()
    base = _serve(params, cfg, q, 2)
    assert base == _serve(params, cfg, q, 2)  # deterministic
    for bsz in (1, 3):
        assert _serve(params, cfg, q, bsz) == base  # batch size
    rev = _serve(params, cfg, q[::-1], 2)[::-1]  # other rows, other co-residents
    assert rev == base
    assert _serve(params, cfg, q, 2, attention_path="gather") == base
    # a sampled request differs from its greedy decode somewhere, and the
    # engine seed keys the draw
    greedy = _serve(params, cfg, [tserving.ServeRequest(
        prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in q], 2)
    assert any(a != b for a, b in zip(base, greedy))
    assert _serve(params, cfg, q, 2, sample_seed=1) != base


def test_sampling_rule_draws_softmax_of_logits_over_temperature():
    """Gumbel-max over the position-keyed noise: over 6000 positions the
    token frequencies follow softmax(logits / T) within 4 standard errors."""
    _, (cfg, params) = _models()
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1, max_len=64)
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    n, temp = 6000, 0.7
    pos = torch.arange(n)
    draws = eng._pick_wave(logits.expand(n, -1), torch.full((n,), temp), torch.full((n,), 4),
                           pos, sampling=True)
    freq = torch.bincount(draws.long(), minlength=6).double() / n
    p = torch.softmax(logits[0].double() / temp, 0)
    se = torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() <= 4 * se + 1e-9), (freq, p)
    greedy = eng._pick_wave(logits.expand(3, -1), torch.zeros(3), torch.zeros(3), pos[:3], True)
    assert greedy.tolist() == [0, 0, 0]


class _Clock:
    """A clock that advances one second per chunk (the heartbeat ticks it)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, _committed):
        self.t += 1.0


def test_deadlines_and_shedding_with_an_injected_clock():
    _, (cfg, params) = _models()
    clock = _Clock()
    rng = np.random.RandomState(2)
    q = [tserving.ServeRequest(prompt=rng.randint(0, 256, size=5).tolist(), max_new_tokens=20,
                               deadline_s=d, priority=pri)
         for d, pri in ((2.5, 1), (0.0, 5), (0.0, 0), (0.0, 3))]
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1, max_len=64,
                                 chunk=2, kv_block_size=8, max_queue_depth=2, clock=clock)
    results, m = eng.serve(q, heartbeat=clock.tick)
    # 3 wait behind the one row; the bound keeps 2: the lowest priority sheds
    assert results[2].status == tserving.STATUS_SHED and results[2].new_tokens == 0
    # the first request is cancelled at the chunk boundary past its deadline
    first = results[0]
    assert first.status == tserving.STATUS_DEADLINE_EXCEEDED and 0 < first.new_tokens < 20
    ref = tllama.generate(params, cfg, torch.tensor([q[0].prompt], dtype=torch.int32), 20)
    assert first.tokens == ref[0, : len(first.tokens)].tolist()  # a true prefix
    assert results[1].status == results[3].status == tserving.STATUS_OK
    assert m["shed_requests"] == 1 and m["deadline_miss_requests"] == 1
    assert m["deadline_cancelled_rows"] == 1 and m["ok_requests"] == 2
    assert m["kv_allocated_blocks_final"] == m["kv_reserved_blocks_final"] == 0
    # a request queued past max_queue_delay_s sheds before admission
    clock2 = _Clock()
    eng2 = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1,
                                  max_len=64, chunk=2, kv_block_size=8, max_queue_delay_s=1.5,
                                  clock=clock2)
    res2, m2 = eng2.serve(q[1:3], heartbeat=clock2.tick)
    assert res2[0].status == tserving.STATUS_OK and res2[1].status == tserving.STATUS_SHED


class _CancelAfter:
    def __init__(self, chunks):
        self.left = chunks

    def tick(self, _committed):
        self.left -= 1

    def cancelled(self):
        return self.left <= 0


def test_cancel_drain_leaves_a_leak_free_pool_and_a_sound_radix_tree():
    _, (cfg, params) = _models()
    q = _queue() * 2
    cancel = _CancelAfter(3)
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=2, max_len=64,
                                 chunk=4, prefill_chunk=3, kv_block_size=8)
    results, m = eng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q],
                           cancel=cancel, heartbeat=cancel.tick)
    assert m["interrupted"] and eng.last_drain
    assert len(eng.last_drain) + sum(r is not None for r in results) == len(q)
    part = eng._alloc.pool_partition()
    assert part["allocated"] == part["reserved"] == 0
    assert part["free"] + part["parked"] == part["total"]
    eng.last_prefix_index.audit()
    for d in eng.last_drain:  # committed tokens are a prefix of the full decode
        p, n = q[d.request_idx]
        full = tllama.generate(params, cfg, torch.tensor([p], dtype=torch.int32), n)[0, len(p):]
        assert d.committed == full[: len(d.committed)].tolist()


def test_warm_engine_second_call_is_identical_and_hits_across_calls():
    _, (cfg, params) = _models()
    q = [tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in _queue()]
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=2, max_len=64,
                                 chunk=4, prefill_chunk=3, kv_block_size=8)
    first, _ = eng.serve(q)
    second, m = eng.serve(q)
    assert [r.tokens for r in first] == [r.tokens for r in second]
    assert m["engine_serve_calls"] == 2 and m["prefix_hit_tokens_cross_call"] > 0
    eng.reset_cache()
    _, m3 = eng.serve(q)
    assert m3["prefix_hit_tokens_cross_call"] == 0 and m3["cache_resets"] == 1


def test_unported_engine_features_raise_naming_their_roadmap_item():
    """Every engine feature of the later serving items is ported: the
    tracer and the live gauges (item 1d) run, and the rest below."""
    from nexus_tpu_torch.obs import ServeTracer, validate_trace

    _, (cfg, params) = _models()
    tracer = ServeTracer()
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1, max_len=64,
                                 tracer=tracer, live_gauges=True)
    res, m = eng.serve([tserving.ServeRequest(prompt=[1, 2, 3], max_new_tokens=3)])
    assert res[0].new_tokens == 3 and m["traced"] is True and m["live_gauge_publishes"] > 0
    assert validate_trace(tracer.to_dict()) == [] and m["flight_recorder_events"] > 0
    # the host tier (item 1b) and streamed arrivals (item 1c) are ported:
    # an engine with a host budget serves a request streamed at t = 0
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1, max_len=64,
                                 host_cache_bytes=1 << 20)
    res, m = eng.serve([], source=ListSource([(0.0, tserving.ServeRequest(prompt=[1, 2, 3],
                                                                          max_new_tokens=3))]))
    assert res[0].new_tokens == 3 and m["streamed_requests"] == 1
    assert m["host_cache_enabled"] is True
    # speculation (item 1a) is ported: the lookup tier serves
    spec = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1, max_len=64,
                                  lookup_ngram=2)
    res, m = spec.serve([tserving.ServeRequest(prompt=[5, 6, 7, 5, 6], max_new_tokens=4)])
    assert res[0].new_tokens == 4 and m["speculative_kind"] == "prompt_lookup"
