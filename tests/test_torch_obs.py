"""The port's serve-plane observability (nexus_tpu_torch.obs and the
engine's hooks) against the JAX package's, on the CPU.

* The engines: tiny Llama in float32 with the same weights in both
  packages (interop.llama_params_from_jax), the same queue, a fake clock
  that ticks 1 ms at every read and that each chunk's heartbeat advances
  by 50 ms (and a stream's waits by their sleep). Both engines read the
  clock at the same points, in the same order, so the
  tracer dumps are EQUAL, span for span and time for time, for closed,
  streamed, prompt-lookup and host-tier runs; so are the flight dumps of a
  drain, a shed storm and a planted sanitizer fault, and the registry
  snapshot and Prometheus text after the same run.
* The dumps pass both packages' validators and the golden schema file
  (tests/golden/serve_trace_schema.json); tracing never changes tokens.
* The units: the recorder's ring and dump bounds, the rolling percentiles,
  an empty window that publishes nothing, the exposition format.
* In a subprocess with NEXUS_OBS_JAX_TRACE=1, a CPU ``torch.profiler``
  capture of a serve call holds the ``nexus.serve.*`` scopes.
"""

import copy
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu import obs as jobs
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.runtime import traffic as jtraffic
from nexus_tpu.utils import telemetry as jtelemetry
from nexus_tpu_torch import obs as tobs
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.obs import profiling as tprofiling
from nexus_tpu_torch.obs.recorder import FLIGHT_EVENT_KINDS
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime import traffic as ttraffic
from nexus_tpu_torch.utils import telemetry as ttelemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "serve_trace_schema.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch gains nothing from
    threads at these shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    jparams = jllama.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.config("tiny", dtype="float32")
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    return {"jax": (jserving, jtraffic, jllama.forward_decode, jparams, jcfg),
            "torch": (tserving, ttraffic, tllama.forward_decode, tparams, tcfg)}


class FakeClock:
    """A clock that ticks 1 ms at every read (and advances by a sleep): two
    engines give the same stamps only if they read it at the same points,
    in the same order, as often."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        self.t += TICK_S
        return self.t

    def sleep(self, s: float) -> None:
        self.t += float(s)


TICK_S = 0.001
CHUNK_S = 0.05  # fake time one decode chunk takes
ENGINE = dict(batch_size=2, max_len=96, chunk=4, prefill_chunk=3, kv_block_size=8)
CHAT = dict(seed=5, requests=8, duration_s=1.0, vocab_size=256, n_prefixes=2, prefix_tokens=16,
            tail_tokens=4, max_new_tokens=5, multi_turn_frac=0.3, branch_frac=0.2, fanout=2)


def _queue():
    """A shared 16-token preamble under three requests, a block-aligned
    duplicate (a copy-on-write hit), an unshared control."""
    rng = np.random.RandomState(23)
    common = rng.randint(0, 256, size=16).tolist()
    q = [(common + rng.randint(0, 256, size=p).tolist(), n) for p, n in ((8, 6), (5, 5), (12, 7))]
    q.append((list(q[0][0]), 4))
    q.append((rng.randint(0, 256, size=7).tolist(), 6))
    return q


def _plain(x):
    """A dump with numpy scalars turned into Python numbers."""
    return json.loads(json.dumps(x, default=lambda v: v.item()))


def _run(side, models, queue=None, streamed=False, cancel_after=0, engine_kw=None, **serve_kw):
    """Serve on one package's engine with a tracer, on a fake clock →
    (engine, tracer, results, metrics)."""
    serving, traffic, fwd, params, cfg = models[side]
    pkg = tobs if side == "torch" else jobs
    clk = FakeClock()
    tracer = pkg.ServeTracer()
    eng = serving.ServingEngine(fwd, params, cfg, clock=clk, tracer=tracer,
                                **dict(ENGINE, **(engine_kw or {})))
    beats = [0]

    class Cancel:
        def cancelled(self):
            return bool(cancel_after) and beats[0] >= cancel_after

    def heartbeat(_):
        beats[0] += 1
        clk.sleep(CHUNK_S)

    if streamed:
        src = traffic.TraceSource(traffic.synthesize_trace(**CHAT), sleep=clk.sleep)
        res, m = eng.serve([], source=src, heartbeat=heartbeat, cancel=Cancel(), **serve_kw)
    else:
        reqs = [serving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in (queue or _queue())]
        res, m = eng.serve(reqs, heartbeat=heartbeat, cancel=Cancel(), **serve_kw)
    return eng, tracer, res, m


TRACED_RUNS = {
    "closed": dict(),
    "streamed": dict(streamed=True),
    "prompt-lookup": dict(engine_kw=dict(lookup_ngram=2, num_speculative=2)),
    "host-tier": dict(streamed=True, engine_kw=dict(kv_num_blocks=8, host_cache_bytes=1 << 20)),
    "gather-int8-pool": dict(engine_kw=dict(attention_path="gather", kv_pool_dtype="int8")),
}


@pytest.mark.parametrize("run", sorted(TRACED_RUNS))
def test_tracer_dump_equals_the_jax_engines(models, run):
    kw = TRACED_RUNS[run]
    _, jtr, jres, jm = _run("jax", models, **kw)
    _, ttr, tres, tm = _run("torch", models, **kw)
    jdump, tdump = _plain(jtr.to_dict()), ttr.to_dict()
    assert tdump == jdump
    assert [r.tokens for r in tres] == [[int(x) for x in r.tokens] for r in jres]
    for key in ("traced", "flight_recorder_events", "flight_dumps", "live_gauge_publishes",
                "committed_tokens", "decode_chunks"):
        assert tm[key] == jm[key], key
    # both packages' validators accept both dumps
    assert tobs.validate_trace(tdump) == [] and jobs.validate_trace(tdump) == []
    kinds = {s["kind"] for e in tdump["spans"] for s in e["timeline"]}
    assert {"enqueued", "admitted", "first_token", "decode_wave", "terminal"} <= kinds
    if run == "host-tier":
        assert tm["restored_blocks"] > 0
        assert any(s["restored_blocks"] > 0 for e in tdump["spans"] for s in e["timeline"]
                   if s["kind"] == "admitted")
    if run == "prompt-lookup":
        waves = [s for e in tdump["spans"] for s in e["timeline"] if s["kind"] == "decode_wave"]
        assert sum(s["tokens"] for s in waves) == tm["committed_tokens"]


def test_trace_schema_matches_the_golden_file(models):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["span_fields"] == {k: ["kind"] + list(v) for k, v in tobs.SPAN_FIELDS.items()}
    assert golden["flight_event_kinds"] == list(FLIGHT_EVENT_KINDS)
    _, tracer, _, _ = _run("torch", models)
    dump = tracer.to_dict()
    assert dump["schema_version"] == golden["trace_schema_version"]
    seen = set()
    for entry in dump["spans"]:
        for span in entry["timeline"]:
            seen.add(span["kind"])
            assert list(span.keys()) == golden["span_fields"][span["kind"]]
    assert {"enqueued", "admitted", "prefill_chunk", "first_token", "decode_wave",
            "lease_grow", "terminal"} <= seen


def test_tracing_never_changes_tokens(models):
    serving, _, fwd, params, cfg = models["torch"]
    reqs = [serving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in _queue()]
    plain = serving.ServingEngine(fwd, params, cfg, flight_recorder=False, live_gauges=False,
                                  **ENGINE)
    traced = serving.ServingEngine(fwd, params, cfg, tracer=tobs.ServeTracer(), **ENGINE)
    res_p, m_p = plain.serve(reqs)
    res_t, m_t = traced.serve(reqs)
    assert [r.tokens for r in res_p] == [r.tokens for r in res_t]
    assert (m_p["traced"], m_t["traced"]) == (False, True)
    assert m_p["flight_recorder_events"] == m_p["live_gauge_publishes"] == 0


def test_the_per_call_tracer_overrides_the_engines(models):
    _, (engine_tracer), _, _ = _run("torch", models)
    serving, _, fwd, params, cfg = models["torch"]
    eng = serving.ServingEngine(fwd, params, cfg, tracer=engine_tracer, **ENGINE)
    runs = engine_tracer.runs
    call = tobs.ServeTracer()
    reqs = [serving.ServeRequest(prompt=[1, 2, 3], max_new_tokens=2, journey="j7")]
    eng.serve(reqs, tracer=call)
    assert engine_tracer.runs == runs and call.runs == 1
    assert call.to_dict()["spans"][0]["journey"] == "j7"


def test_validate_trace_flags_schema_drift():
    t = tobs.ServeTracer()
    t.begin(1)
    t.event(0, "enqueued", t=0.0, prompt_tokens=2, max_new_tokens=4)
    t.event(0, "terminal", t=1.0, status="ok", new_tokens=4, latency_s=1.0,
            finished_by_stop=False)
    base = t.to_dict()
    assert tobs.validate_trace(base) == []
    for mutate, needle in ((lambda d: d["spans"][0]["timeline"][0].update(extra=1), "fields"),
                           (lambda d: d["spans"][0]["timeline"][1].update(kind="x"),
                            "unknown kind"),
                           (lambda d: d["spans"][0]["timeline"][1].update(t=-5.0), "backwards"),
                           (lambda d: d["spans"][0]["timeline"].pop(), "not terminal")):
        dump = copy.deepcopy(base)
        mutate(dump)
        problems = tobs.validate_trace(dump)
        assert any(needle in p for p in problems), needle
        assert problems == jobs.validate_trace(dump)


# ------------------------------------------------------------ flight recorder

def test_flight_recorder_ring_and_dumps_are_bounded_like_jax():
    for pkg in (tobs, jobs):
        rec = pkg.FlightRecorder(capacity=4)
        for i in range(10):
            rec.record("wave", t=float(i), wave=i)
        dump = rec.trip("drain", t=10.0, detail={"drained": [1, 2]})
        assert rec.events_recorded == 10 and len(dump["events"]) == 4
        assert [e["wave"] for e in dump["events"]] == [6, 7, 8, 9]
        assert pkg.validate_flight_dump(dump) == []
        small = pkg.FlightRecorder(capacity=2, max_dumps=3)
        for i in range(5):
            small.record("wave", t=float(i), wave=i)
            small.trip("drain", t=float(i), detail={"n": i})
        assert [d["detail"]["n"] for d in small.dumps] == [2, 3, 4]
    with pytest.raises(ValueError):
        tobs.FlightRecorder(capacity=0)


def test_the_drain_trip_equals_the_jax_engines(models):
    q = [(p, 30) for p, _ in _queue()[:3]]
    jeng, jtr, _, jm = _run("jax", models, queue=q, cancel_after=2)
    teng, ttr, _, tm = _run("torch", models, queue=q, cancel_after=2)
    assert tm["interrupted"] is True and tm["flight_dumps"] == jm["flight_dumps"] == 1
    dump = teng.last_flight_dump
    assert dump == _plain(jeng.last_flight_dump)
    assert dump["reason"] == "drain" and tobs.validate_flight_dump(dump) == []
    drained = sorted(d.request_idx for d in teng.last_drain)
    assert sorted(dump["detail"]["drained"]) == drained
    tail = [e for e in dump["events"] if e["kind"] == "drain_request"]
    assert sorted(e["request"] for e in tail) == drained
    assert any(e["admitted"] and e["committed"] > 0 for e in tail)
    # the tracer's timelines end drained, and the dump still validates
    assert ttr.to_dict() == _plain(jtr.to_dict())
    assert tobs.validate_trace(ttr.to_dict()) == []


def test_a_shed_storm_trips_once_like_the_jax_engine(models):
    q = [([1, 2, 3, 4], 4)] * 8
    kw = dict(engine_kw=dict(batch_size=1, max_queue_depth=1, storm_threshold=3))
    jeng, _, _, jm = _run("jax", models, queue=q, **kw)
    teng, _, _, tm = _run("torch", models, queue=q, **kw)
    assert tm["shed_requests"] >= 3 and tm["flight_dumps"] == jm["flight_dumps"] == 1
    dump = teng.last_flight_dump
    assert dump["reason"] == "shed_storm" and dump["detail"]["shed"] >= 3
    assert dump == _plain(jeng.last_flight_dump)
    assert len([e for e in dump["events"] if e["kind"] == "shed"]) >= 3


def test_a_planted_sanitizer_fault_dumps_like_the_jax_engine(models, monkeypatch):
    """A block-table tail entry that is not the scratch block: the in-loop
    scratch-tail audit (NEXUS_SANITIZE) raises, and the flight dump on its
    way out equals JAX's."""
    monkeypatch.setenv("NEXUS_SANITIZE", "1")
    dumps = {}
    for side in ("jax", "torch"):
        serving, _, fwd, params, cfg = models[side]
        clk = FakeClock()
        eng = serving.ServingEngine(fwd, params, cfg, clock=clk, **ENGINE)
        eng._table_np[1, -1] = 0  # row 1 is free: its whole row must be scratch
        reqs = [serving.ServeRequest(prompt=[5, 6, 7], max_new_tokens=3)]
        with pytest.raises(AssertionError, match="scratch-tail contract"):
            eng.serve(reqs, heartbeat=lambda _: clk.sleep(CHUNK_S))
        dumps[side] = _plain(eng.last_flight_dump)
    assert dumps["torch"] == dumps["jax"]
    assert dumps["torch"]["reason"] == "sanitizer"
    assert "scratch-tail" in dumps["torch"]["detail"]["error"]


def test_the_flight_recorder_off_switch(models):
    serving, _, fwd, params, cfg = models["torch"]
    eng = serving.ServingEngine(fwd, params, cfg, flight_recorder=False, **ENGINE)
    _, m = eng.serve([serving.ServeRequest(prompt=[1, 2], max_new_tokens=3)])
    assert eng.flight_recorder is None and m["flight_recorder_events"] == 0
    # set_observability swaps them back on for the next call
    eng.set_observability(flight_recorder=None, live_gauges=True)
    _, m = eng.serve([serving.ServeRequest(prompt=[1, 2], max_new_tokens=3)])
    assert m["flight_recorder_events"] > 0 and m["live_gauge_publishes"] > 0


def test_no_hook_reads_a_tensor(models, monkeypatch):
    """The engine reads its tensors to the host once a chunk; the tracer,
    recorder and gauges add no read: a run with them all on makes as many
    tensor-to-host calls as a run with them all off."""
    serving, traffic, fwd, params, cfg = models["torch"]
    reads = [0]
    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads[0] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    counts = []
    for obs_on in (False, True):
        eng = serving.ServingEngine(
            fwd, params, cfg, tracer=tobs.ServeTracer() if obs_on else None,
            flight_recorder=None if obs_on else False, live_gauges=obs_on,
            **dict(ENGINE, kv_num_blocks=8, host_cache_bytes=1 << 20))
        eng.warmup()
        reads[0] = 0
        clk = FakeClock()
        src = traffic.TraceSource(traffic.synthesize_trace(**CHAT), sleep=clk.sleep)
        eng._clock = clk
        _, m = eng.serve([], source=src, heartbeat=lambda _: clk.sleep(CHUNK_S))
        counts.append((reads[0], m["decode_chunks"], m["traced"], m["live_gauge_publishes"]))
    (off, chunks_off, _, _), (on, chunks_on, traced, publishes) = counts
    assert traced and publishes > 0 and chunks_on == chunks_off
    assert on == off > 0


# ---------------------------------------------------------------- live gauges

@pytest.mark.parametrize("streamed", [False, True], ids=["closed", "streamed"])
def test_registry_and_prometheus_text_equal_the_jax_engines(models, monkeypatch, streamed):
    """A fresh process registry in each package, one run each with the
    engine's gauges tagged ``engine:t0``: the same snapshot and the same
    exposition text (the app name is the JAX package's)."""
    out = {}
    for side, tele, pkg in (("jax", jtelemetry, jobs), ("torch", ttelemetry, tobs)):
        monkeypatch.setattr(tele, "_default_client", tele.StatsdClient())
        _, _, _, m = _run(side, models, streamed=streamed,
                          engine_kw=dict(gauge_tags=["engine:t0"], kv_num_blocks=10,
                                         host_cache_bytes=1 << 20))
        out[side] = (_plain(pkg.registry_snapshot()), pkg.render_prometheus(), m)
    (jsnap, jtext, jm), (tsnap, ttext, tm) = out["jax"], out["torch"]
    assert tsnap == jsnap and ttext == jtext
    assert tm["live_gauge_publishes"] == jm["live_gauge_publishes"] > 0
    assert 'nexus_tpu_serve_queue_depth{engine="t0"}' in ttext
    assert 'nexus_tpu_serve_ttft_p95_s{engine="t0"}' in ttext
    sample = ttelemetry.get_client().get_tagged("serve_waves_total", ["engine:t0"])
    assert sample.value == tm["decode_chunks"] and sample.stamp == float(tm["decode_chunks"])


def test_live_gauges_publish_once_a_wave(models):
    serving, _, fwd, params, cfg = models["torch"]
    eng = serving.ServingEngine(fwd, params, cfg, **ENGINE)
    _, m = eng.serve([serving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in _queue()])
    assert m["live_gauge_publishes"] == m["decode_chunks"] > 0


def test_an_empty_percentile_window_publishes_nothing():
    client = ttelemetry.StatsdClient("t-obs-empty")
    tobs.LiveGauges(client=client).publish(queue_depth=0, running_rows=0, free_pool_blocks=0,
                                           host_cache_bytes=0, committed_tokens=0, waves=0)
    gauges = client.snapshot()["gauges"]
    assert "t-obs-empty.serve_ttft_p95_s" not in gauges
    assert gauges["t-obs-empty.serve_queue_depth"] == 0


def test_rolling_percentiles_follow_the_jax_estimator():
    rng = np.random.RandomState(3)
    xs = rng.exponential(size=40).tolist()
    t, j = tobs.RollingPercentiles(window=16), jobs.RollingPercentiles(window=16)
    assert all(math.isnan(v) for v in t.percentiles((0.5, 0.95)))
    for x in xs:
        t.add(x)
        j.add(x)
        assert t.percentiles((0.0, 0.5, 0.95)) == j.percentiles((0.0, 0.5, 0.95))
    assert len(t) == 16 and t.count == 40
    assert t.percentile(0.5) == ttelemetry.percentile_nearest_rank(xs[-16:], 0.5)


def test_the_registry_client_follows_the_jax_client():
    tc, jc = ttelemetry.StatsdClient("app-x"), jtelemetry.StatsdClient("app-x")
    for c in (tc, jc):
        c.gauge("serve_queue_depth", 4, tags=["engine:a"], stamp=3.0)
        c.gauge("serve_queue_depth", 7, tags=["engine:b"])
        c.gauge("reconcile.latency", 0.5)
        c.gauge("serve_queue_depth", 5, tags=["engine:a", "zone:z"])
    assert tc.snapshot() == jc.snapshot()
    assert tuple(tc.get_tagged("serve_queue_depth", ["engine:a"])) == (4.0, 1, 3.0)
    assert tc.get_tagged("serve_queue_depth", ["engine:c"]) is None
    assert ({k: tuple(v) for k, v in tc.tagged_series("engine:a").items()}
            == {k: tuple(v) for k, v in jc.tagged_series("engine:a").items()})
    text = tobs.render_prometheus(tc)
    assert text == jobs.render_prometheus(jc) and text == tobs.render_prometheus(tc)
    assert 'app_x_serve_queue_depth{engine="a"} 4' in text
    assert "app_x_reconcile_latency 0.5" in text
    assert tobs.registry_snapshot(tc) == jobs.registry_snapshot(jc)
    json.dumps(tobs.registry_snapshot(tc))


def test_the_statsd_send_happens_only_with_an_address(monkeypatch):
    import socket

    monkeypatch.delenv("NEXUS__STATSD_ADDRESS", raising=False)
    assert ttelemetry.StatsdClient()._sock is None
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(5)
    try:
        port = recv.getsockname()[1]
        monkeypatch.setenv("NEXUS__STATSD_ADDRESS", f"127.0.0.1:{port}")
        client = ttelemetry.StatsdClient("app")
        client.gauge("serve_queue_depth", 3, tags=["engine:r0"])
        assert recv.recv(512) == b"app.serve_queue_depth:3|g|@1.0|#engine:r0"
    finally:
        recv.close()


def test_with_statsd_installs_the_process_default(monkeypatch):
    monkeypatch.setattr(ttelemetry, "_default_client", None)
    first = ttelemetry.get_client()
    assert ttelemetry.get_client() is first and first.app_name == "nexus-tpu"
    mine = ttelemetry.with_statsd("mine")
    assert ttelemetry.get_client() is mine and mine is not first


# --------------------------------------------------------- dispatch scopes

def test_dispatch_annotations_are_the_shared_null_scope_when_off():
    if tprofiling.TRACE_ANNOTATIONS_ENABLED:
        pytest.skip("NEXUS_OBS_JAX_TRACE is set in this process")
    a = tprofiling.dispatch_annotation("nexus.serve.decode_chunk")
    assert a is tprofiling.dispatch_annotation("nexus.serve.insert_wave")
    with a as entered:
        assert entered is a


_PROFILE_SCRIPT = """
import torch
from nexus_tpu_torch.models import llama
from nexus_tpu_torch.obs import profiling
from nexus_tpu_torch.runtime.entrypoints import _decode_params
from nexus_tpu_torch.runtime.serving import ServeRequest, ServingEngine

torch.set_num_threads(1)
assert profiling.TRACE_ANNOTATIONS_ENABLED
cfg = llama.config("tiny", dtype="float32")
params = _decode_params(llama, cfg, torch.device("cpu"), 0)
common = list(range(1, 17))
reqs = [ServeRequest(prompt=common + [20 + i], max_new_tokens=3) for i in range(3)]
eng = ServingEngine(llama.forward_decode, params, cfg, batch_size=2, max_len=64, chunk=2,
                    kv_block_size=8, kv_num_blocks=6, host_cache_bytes=1 << 20)
eng.serve(reqs)
spec = ServingEngine(llama.forward_decode, params, cfg, batch_size=2, max_len=64, chunk=2,
                     kv_block_size=8, lookup_ngram=2, num_speculative=2)
spec.warmup()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    eng.serve(reqs)
    spec.serve(reqs[:1])
print(sorted({e.key for e in prof.key_averages() if e.key.startswith("nexus.serve.")}))
"""


def test_the_profiler_sees_the_dispatch_scopes_when_the_flag_is_set():
    env = dict(os.environ, NEXUS_OBS_JAX_TRACE="1", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROFILE_SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    scopes = json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"'))
    assert {"nexus.serve.decode_chunk", "nexus.serve.insert_wave",
            "nexus.serve.spec_chunk"} <= set(scopes)


def test_profile_serves_scope_table_and_overhead_ab_on_the_cpu(models, monkeypatch):
    """tools/profile_serve.py's two parts on a tiny engine: the table by
    dispatch scope from a CPU capture (host time only here), and the
    on/off turns of the overhead A/B."""
    from nexus_tpu_torch.tools.profile_serve import overhead_ab, scope_table

    serving, _, fwd, params, cfg = models["torch"]
    reqs = [serving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in _queue()]
    eng = serving.ServingEngine(fwd, params, cfg, **ENGINE)
    eng.warmup()
    monkeypatch.setattr(tprofiling, "TRACE_ANNOTATIONS_ENABLED", True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, m = eng.serve(reqs)
    steps = m["decode_chunks"] * ENGINE["chunk"]
    table = scope_table(prof.key_averages(), steps)
    assert set(table) == {"nexus.serve.decode_chunk", "nexus.serve.insert_wave"}
    chunk = table["nexus.serve.decode_chunk"]
    assert chunk["calls_per_step"] == pytest.approx(1 / ENGINE["chunk"])
    assert chunk["host_ms_per_step"] > 0 and chunk["device_ms_per_step"] == 0
    monkeypatch.setattr(tprofiling, "TRACE_ANNOTATIONS_ENABLED", False)
    ab = overhead_ab(eng, reqs, rounds=2)
    assert len(ab["tokens_per_sec_on"]) == len(ab["tokens_per_sec_off"]) == 2
    assert math.isfinite(ab["overhead_share"])
