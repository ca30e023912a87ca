"""Open-loop arrivals in the port (nexus_tpu_torch.runtime.traffic and
``serve(source=...)``) against the JAX package, on the CPU.

* The trace: the same seed and knobs synthesize the same ``to_dict()`` as
  JAX's, for Poisson, bursty, multi-turn and branching traces, and it
  round-trips.
* The sources, on a fake clock: the same ``poll`` / ``due`` / ``wait`` /
  ``exhausted`` sequence as JAX's.
* Streamed serving, tiny Llama in float32 with the same weights in both
  engines, on a fake clock that a chunk advances by 50 ms (the heartbeat)
  and an idle wait by its sleep: the port's streamed serve commits the
  tokens of its own closed-loop serve of the same requests and of the JAX
  engine's streamed serve, with JAX's ledger (clock-derived keys included:
  on the fake clock both engines read the same times).
* The entry point: ``serve.arrival`` poisson / bursty streams the trace
  and reports JAX's ``arrival``, ``trace_version``, ``trace_events``,
  ``streamed_requests`` and committed tokens; ``budget_tokens`` and
  ``completion_ids`` cover the trace's requests in arrival order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.runtime import traffic as jtraffic
from nexus_tpu_torch.api import runtime_spec as tspec
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.runtime import entrypoints as tentry
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime import traffic as ttraffic


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch gains nothing from
    threads at these shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """now() and a sleep that advances it: a stream replays exactly."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += float(s)


TRACE_KNOBS = {
    "poisson": dict(seed=3, requests=12, duration_s=2.0, vocab_size=64),
    "bursty": dict(seed=9, requests=14, duration_s=2.0, arrival="bursty", burst_duty=0.2,
                   burst_count=3, vocab_size=64),
    "multi_turn": dict(seed=6, requests=8, duration_s=1.0, vocab_size=32, multi_turn_frac=0.5,
                       turns=3, max_new_tokens=6, think_s=0.5, n_prefixes=2, zipf_a=2.0),
    "branching": dict(seed=8, requests=6, duration_s=0.5, vocab_size=32, branch_frac=0.5,
                      fanout=3, max_new_tokens=5, think_s=0.3, prefix_tokens=16,
                      tail_tokens=4),
}


@pytest.mark.parametrize("kind", sorted(TRACE_KNOBS))
def test_synthesis_matches_the_jax_trace(kind):
    kw = TRACE_KNOBS[kind]
    got = ttraffic.synthesize_trace(**kw).to_dict()
    assert got == jtraffic.synthesize_trace(**kw).to_dict()
    assert ttraffic.Trace.from_dict(got).to_dict() == got
    assert got["trace_version"] == ttraffic.TRACE_VERSION == jtraffic.TRACE_VERSION
    with pytest.raises(ValueError):
        ttraffic.Trace.from_dict(dict(got, trace_version=ttraffic.TRACE_VERSION + 1))
    if kind == "multi_turn":
        assert {ev["kind"] for ev in got["events"]} == {"single", "turn"}
    if kind == "branching":
        assert "branch" in {ev["kind"] for ev in got["events"]}


def test_synthesis_refuses_what_jax_refuses():
    for bad in (dict(arrival="sawtooth"), dict(requests=0)):
        with pytest.raises(ValueError):
            jtraffic.synthesize_trace(**bad)
        with pytest.raises(ValueError):
            ttraffic.synthesize_trace(**bad)


def _request_view(r):
    return (list(r.prompt), r.max_new_tokens, r.temperature, r.seed, r.deadline_s, r.priority,
            r.arrival_s)


def _drive(src, clk, times):
    """poll / due / exhausted at each time, then a wait from there: the
    sequence of answers and of clock advances."""
    out = []
    for now in times:
        clk.t = now
        out.append(("due", src.due(now)))
        out.append(("poll", [_request_view(r) for r in src.poll(now)]))
        out.append(("exhausted", src.exhausted(), src.delivered))
        src.wait(now)
        out.append(("waited", round(clk.t - now, 9)))
    return out


TIMES = (0.0, 0.1, 0.5, 0.51, 0.9, 1.7, 2.0, 3.0, 9.0)


def test_trace_source_follows_the_jax_source():
    kw = dict(seed=4, requests=6, duration_s=2.0, vocab_size=32, multi_turn_frac=0.5, turns=2,
              think_s=0.3)
    answers = []
    for traffic in (jtraffic, ttraffic):
        clk = FakeClock()
        src = traffic.TraceSource(traffic.synthesize_trace(**kw), deadline_s=9.0, priority=2,
                                  speed=2.0, sleep=clk.sleep, max_wait_s=0.25)
        assert len(src) == 9
        answers.append(_drive(src, clk, TIMES))
    assert answers[0] == answers[1]
    assert any(a[0] == "waited" and a[1] > 0 for a in answers[1])


def test_list_source_follows_the_jax_source():
    answers = []
    for serving, traffic in ((jserving, jtraffic), (tserving, ttraffic)):
        clk = FakeClock()
        timed = [(t, serving.ServeRequest(prompt=[i, i + 1], max_new_tokens=2))
                 for i, t in enumerate((1.0, 0.25, 0.5, 0.5))]
        src = traffic.ListSource(timed, sleep=clk.sleep, max_wait_s=10.0)
        answers.append(_drive(src, clk, TIMES))
    assert answers[0] == answers[1]


# ----------------------------------------------------------- streamed serve


def _models():
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    jparams = jllama.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.config("tiny", dtype="float32")
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    return (jcfg, jparams), (tcfg, tparams)


# a chat-shaped trace: two shared preambles, multi-turn sessions, a fan-out
CHAT = dict(seed=5, requests=8, duration_s=1.0, vocab_size=256, n_prefixes=2, prefix_tokens=16,
            tail_tokens=4, max_new_tokens=5, multi_turn_frac=0.3, branch_frac=0.2, fanout=2)
ENGINE = dict(batch_size=2, max_len=96, chunk=4, prefill_chunk=3, kv_block_size=8)
CHUNK_S = 0.05  # fake time one decode chunk takes


def _stream(serving, traffic, fwd, params, cfg, **kw):
    clk = FakeClock()
    eng = serving.ServingEngine(fwd, params, cfg, clock=clk, **ENGINE, **kw)
    src = traffic.TraceSource(traffic.synthesize_trace(**CHAT), sleep=clk.sleep)
    results, metrics = eng.serve([], source=src, heartbeat=lambda _: clk.sleep(CHUNK_S))
    return eng, results, metrics


# the wall clock's keys, and the observability keys (off in the port)
WALL = ("wall_s", "tokens_per_sec", "traced", "flight_recorder_events", "flight_dumps",
        "live_gauge_publishes")


@pytest.mark.parametrize("kw", [
    {}, dict(kv_num_blocks=12), dict(kv_num_blocks=8, host_cache_bytes=1 << 20),
    # speculation's rounds and the stream share the wave boundary
    dict(kv_num_blocks=8, host_cache_bytes=1 << 20, lookup_ngram=2, num_speculative=2),
], ids=["roomy-pool", "tight-pool", "tight-pool-host-tier", "lookup-host-tier"])
def test_streamed_serve_matches_closed_loop_and_the_jax_engine(kw):
    (jcfg, jparams), (tcfg, tparams) = _models()
    _, jres, jmet = _stream(jserving, jtraffic, jllama.forward_decode, jparams, jcfg, **kw)
    teng, tres, tmet = _stream(tserving, ttraffic, tllama.forward_decode, tparams, tcfg, **kw)
    n = len(ttraffic.synthesize_trace(**CHAT))
    assert len(tres) == len(jres) == n == tmet["streamed_requests"] == jmet["streamed_requests"]
    assert len(teng.last_requests) == n
    for a, b in zip(tres, jres):
        assert a.tokens == [int(x) for x in b.tokens]
        assert (a.new_tokens, a.status) == (b.new_tokens, b.status)
        # the fake clock is read at the same points: the same times
        assert (a.queue_s, a.ttft_s) == (b.queue_s, b.ttft_s)
        assert a.latency_s == pytest.approx(b.latency_s)
    common = [k for k in jmet if k in tmet and k not in WALL]
    assert {k: tmet[k] for k in common} == {k: jmet[k] for k in common}
    for key in ("ttft_p95_s", "queue_p95_s", "decode_chunks", "prefix_hit_tokens"):
        assert key in common
    assert tmet["wall_s"] == pytest.approx(jmet["wall_s"], abs=1e-3)
    if kw.get("host_cache_bytes"):
        assert tmet["spilled_blocks"] > 0 and tmet["restored_blocks"] > 0
    # the closed loop over the same requests commits the same tokens
    closed = tserving.ServingEngine(tllama.forward_decode, tparams, tcfg, **ENGINE, **kw)
    cres, _ = closed.serve(ttraffic.synthesize_trace(**CHAT).to_requests())
    assert [r.tokens for r in cres] == [r.tokens for r in tres]


def test_streamed_serve_waits_for_late_arrivals_and_never_spins():
    """A stream whose first arrival is 3 s out: the engine waits through
    the source's sleep (capped steps, each one heartbeat), then serves;
    queue time and ttft anchor at arrival, not at serve() entry."""
    _, (cfg, params) = _models()
    clk = FakeClock()
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        clk.sleep(s)

    beats = []
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, clock=clk, **ENGINE)
    req = tserving.ServeRequest(prompt=[3, 1, 4, 1, 5], max_new_tokens=4)
    src = ttraffic.ListSource([(3.0, req), (3.2, req)], sleep=sleep, max_wait_s=0.5)
    res, m = eng.serve([], source=src, heartbeat=lambda c: (beats.append(c), clk.sleep(0.01)))
    assert [r.new_tokens for r in res] == [4, 4] and m["streamed_requests"] == 2
    # every idle pass beats once and sleeps at most max_wait_s toward 3.0
    assert all(s <= 0.5 for s in sleeps) and len(sleeps) >= 6 and len(beats) > len(sleeps)
    assert clk.t >= 3.2
    assert all(r.queue_s < 0.5 for r in res)  # from arrival, not from t = 0
    assert res[0].latency_s < 3.0
    assert m["ttft_p95_s"] < 0.5


def test_queue_s_anchors_at_arrival():
    """A request stamped as arrived 2.5 s before the call charges that wait
    to queue_s and latency_s (and the ttft rollup); ttft_s stays
    admission-based. The JAX engine gives the same numbers."""
    (jcfg, jparams), (tcfg, tparams) = _models()
    out = []
    for serving, fwd, params, cfg in ((jserving, jllama.forward_decode, jparams, jcfg),
                                      (tserving, tllama.forward_decode, tparams, tcfg)):
        clk = FakeClock()
        eng = serving.ServingEngine(fwd, params, cfg, clock=clk, **ENGINE)
        reqs = [serving.ServeRequest(prompt=[1, 2, 3], max_new_tokens=4, arrival_s=-2.5),
                serving.ServeRequest(prompt=[4, 5, 6], max_new_tokens=4)]
        res, m = eng.serve(reqs, heartbeat=lambda _: clk.sleep(CHUNK_S))
        out.append(([(r.queue_s, r.ttft_s, round(r.latency_s, 6)) for r in res],
                    m["ttft_p95_s"], m["queue_p95_s"]))
    assert out[0] == out[1]
    (early, fresh), ttft_p95, _ = out[1]
    assert early[0] >= 2.5 and early[2] >= 2.5 and fresh[0] < 2.5 and early[1] < 2.5
    assert ttft_p95 >= 2.5


# -------------------------------------------------------------- entry point


def _open_loop_spec(arrival):
    return {"mode": "serve", "model": {"family": "llama", "preset": "tiny",
                                       "overrides": {"dtype": "float32"}},
            "train": {"batchSize": 2, "seqLen": 64, "seed": 0},
            "serve": {"numRequests": 5, "promptLengthMin": 4, "promptLengthMax": 20,
                      "sharedPrefixLength": 8, "maxNewMin": 3, "maxNewMax": 6, "chunk": 4,
                      "kvBlockSize": 8, "arrival": arrival, "arrivalDurationSeconds": 0.3,
                      "traceMultiTurnFrac": 0.4, "traceTurns": 2, "traceThinkSeconds": 0.1}}


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_entry_point_streams_the_trace_like_the_jax_entry_point(arrival):
    spec = _open_loop_spec(arrival)
    assert tspec.JaxXlaRuntime.from_dict(spec).validate() == []
    got = tentry.run_template_runtime(spec, device="cpu")
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    ref = jrun(jspec.JaxXlaRuntime.from_dict(dict(spec, tpu={"accelerator": "v5e",
                                                             "topology": "1x1"})))
    for key in ("arrival", "trace_version", "trace_events", "streamed_requests", "requests",
                "committed_tokens", "ok_requests", "finished_requests"):
        assert got[key] == ref[key], key
    assert got["arrival"] == arrival and got["streamed_requests"] == got["trace_events"] == 7
    # the budgets and completions of the trace's requests, in arrival order:
    # those of a closed-loop serve of the same requests on the same weights
    rt = tspec.JaxXlaRuntime.from_dict(spec)
    cfg = tllama.config("tiny", dtype="float32")
    trace = tentry._synthetic_trace(rt.serve, rt.train, cfg)
    params = tentry._decode_params(get_family("llama"), cfg, torch.device("cpu"), 0)
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=2,
                                 max_len=cfg.max_seq_len, chunk=4, kv_block_size=8)
    requests = trace.to_requests()
    res, _ = eng.serve(requests)
    assert got["budget_tokens"] == sum(eng.request_budget(r) for r in requests)
    assert got["budget_tokens"] == got["committed_tokens"] > 0
    assert got["completion_ids"] == [r.tokens[len(q.prompt):] for q, r in zip(requests, res)]


def test_open_loop_validation_follows_the_jax_spec():
    base = _open_loop_spec("poisson")
    for serve, needle in (({"arrival": "sawtooth"}, "serve.arrival"),
                          ({"arrivalDurationSeconds": 0}, "arrivalDurationSeconds"),
                          ({"arrivalBurstDuty": 1.5}, "arrivalBurstDuty"),
                          ({"tracePrefixPool": 0}, "tracePrefixPool"),
                          ({"traceMultiTurnFrac": 1.5}, "traceMultiTurnFrac"),
                          ({"traceTurns": 1}, "traceTurns"),
                          ({"traceBranchFrac": 0.5, "traceFanout": 0}, "traceFanout"),
                          ({"traceThinkSeconds": -1}, "traceThinkSeconds"),
                          ({"prompts": ["hi"]}, "mutually exclusive")):
        spec = dict(base, serve=dict(base["serve"], **serve))
        errs = tspec.JaxXlaRuntime.from_dict(spec).validate()
        jerrs = jspec.JaxXlaRuntime.from_dict(spec).validate()
        assert errs and any(needle in e for e in errs), serve
        assert [e for e in errs if needle in e] == [e for e in jerrs if needle in e], serve


def test_the_worst_trace_prompt_must_fit():
    spec = _open_loop_spec("poisson")
    spec["serve"].update(traceTurns=40, maxNewMax=40, maxNewMin=40)
    with pytest.raises(ValueError, match="worst prompt"):
        tentry.run_template_runtime(spec, device="cpu")


def test_fleet_replicas_and_the_trace_dump_still_raise(monkeypatch):
    spec = _open_loop_spec("poisson")
    with pytest.raises(NotImplementedError, match="item 1e"):
        tentry.run_template_runtime(dict(spec, serve=dict(spec["serve"], replicas=2)),
                                    device="cpu")
    monkeypatch.setenv("NEXUS_SERVE_TRACE", "/nonexistent/trace.json")
    with pytest.raises(NotImplementedError, match="item 1d"):
        tentry.run_template_runtime(spec, device="cpu")
