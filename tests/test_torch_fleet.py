"""The port's fleet drive (nexus_tpu_torch.fleet, ha, obs.journey /
fleet_log / federation) against the JAX package's, on the CPU.

* Routing: ``affinity_key`` and ``rendezvous_weight`` are byte-equal to
  JAX's over random prompts; ``route_batch`` makes the same assignments,
  with the same spills and the same decision-log events, under the
  affinity and random policies and with priorities.
* ``serve_fleet_local`` on 2 and 3 replicas of tiny Llama (float32, the
  same weights in both packages, a fake clock that ticks at every read and
  that each chunk's heartbeat advances): JAX's tokens and statuses, clock-free fleet and per-replica
  ledgers, journey dump and decision log (times included: both read the
  same fake clock at the same points), checked against
  tests/golden/fleet_obs_schema.json.
* ``goodput_under_slo``, ``slo_verdicts`` and ``FleetGauges`` give JAX's
  numbers; the planner's requeue and stitch give JAX's entries.
* ``mode: serve`` with ``replicas: 2`` through both entry points: equal
  weight-independent keys, and NEXUS_SERVE_TRACE writes the journey file
  and ``<path>.fleetlog.json``.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu import fleet as jfleet
from nexus_tpu import obs as jobs
from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.ha import serve_failover as jfailover
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.utils import telemetry as jtelemetry
from nexus_tpu_torch import fleet as tfleet
from nexus_tpu_torch import obs as tobs
from nexus_tpu_torch.api import runtime_spec as tspec
from nexus_tpu_torch.ha import serve_failover as tfailover
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.runtime import entrypoints as tentry
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.utils import telemetry as ttelemetry

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "fleet_obs_schema.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch gains nothing from
    threads at these shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """A structure with numpy scalars turned into Python numbers."""
    return json.loads(json.dumps(x, default=lambda v: v.item()))


# ------------------------------------------------------------------ routing

def test_affinity_key_and_rendezvous_weight_are_byte_equal():
    rng = np.random.RandomState(7)
    for _ in range(60):
        prompt = rng.randint(0, 1 << 17, size=int(rng.randint(1, 80))).tolist()
        bs, depth = int(rng.choice([4, 8, 16, 32])), int(rng.randint(1, 4))
        key = tfleet.affinity_key(prompt, bs, depth)
        assert key == jfleet.affinity_key(prompt, bs, depth)
        for rid in ("r0", "r1", "replica-7"):
            assert tfleet.rendezvous_weight(key, rid) == jfleet.rendezvous_weight(key, rid)
    with pytest.raises(ValueError):
        tfleet.affinity_key([1, 2], 8, depth=0)


class _Entry:
    def __init__(self, request):
        self.request = request


def _family_prompts(rng, families=4, per_family=5, block=8):
    out = []
    for f in range(families):
        preamble = rng.randint(0, 256, size=2 * block).tolist()
        for i in range(per_family):
            out.append((preamble + rng.randint(0, 256, size=3 + i).tolist(),
                        int(rng.randint(0, 3))))
    return out


@pytest.mark.parametrize("policy,load", [("affinity", "pending"), ("affinity", "zero"),
                                         ("random", "pending")])
def test_route_batch_makes_the_jax_routers_assignments(policy, load):
    rng = np.random.RandomState(11)
    prompts = _family_prompts(rng)
    hot = [([9] * 16 + [i], 0) for i in range(8)]  # one hot family: spills
    out = {}
    for pkg, serving, obs in ((tfleet, tserving, tobs), (jfleet, jserving, jobs)):
        clock = iter(range(10000)).__next__
        log = obs.FleetDecisionLog(clock=lambda: float(clock()))
        router = pkg.PrefixAffinityRouter(
            ["r0", "r1", "r2"], block_size=8, affinity_depth=2, spill_threshold=2,
            policy=policy, seed=5, decision_log=log,
            load_fn=(lambda _: 0.0) if load == "zero" else None)
        if load == "pending":
            router.enable_pending_load()
        entries = [_Entry(serving.ServeRequest(prompt=p, priority=pri, journey=f"j{i}"))
                   for i, (p, pri) in enumerate(prompts + hot)]
        routed = router.route_batch(entries)
        out[pkg] = ([(entries.index(e), rid, spilled) for e, rid, spilled in routed],
                    router.ledger(), _plain(log.to_dict()))
    assert out[tfleet] == out[jfleet]
    assignments, ledger, log = out[tfleet]
    assert ledger["router_decisions"] == len(prompts) + len(hot)
    assert tobs.validate_fleet_log(log) == []
    if load == "pending" and policy == "affinity":
        assert ledger["router_spills"] > 0
    # priority order: a higher priority routes first
    pris = [(prompts + hot)[i][1] for i, _, _ in assignments]
    assert pris == sorted(pris, reverse=True)


def test_membership_churn_moves_only_the_removed_replicas_keys():
    """Rendezvous homes: removing a replica re-homes only the keys it held,
    as in JAX's router; ``unroute`` takes one routed count back."""
    rng = np.random.RandomState(3)
    keys = [tfleet.affinity_key(rng.randint(0, 256, size=16).tolist(), 8, 2) for _ in range(40)]
    routers = [pkg.PrefixAffinityRouter(["r0", "r1", "r2", "r3"], block_size=8)
               for pkg in (tfleet, jfleet)]
    before = [[r.rank(k)[0] for k in keys] for r in routers]
    for r in routers:
        r.remove_replica("r2")
        r.add_replica("r2")
        r.add_replica("r2")  # already a member: no change
        r.remove_replica("r1")
    after = [[r.rank(k)[0] for k in keys] for r in routers]
    assert before[0] == before[1] and after[0] == after[1]
    assert routers[0].replicas() == ["r0", "r3", "r2"]
    assert all(a == b for a, b in zip(before[0], after[0]) if a != "r1")
    assert "r1" in before[0] and "r1" not in after[0]
    tr = routers[0]
    tr.set_replicas(["r9"])
    tr.route(tserving.ServeRequest(prompt=[1] * 16))
    tr.route(tserving.ServeRequest(prompt=[2] * 16))
    tr.unroute("r9")
    assert tr.ledger()["router_routed"] == {"r9": 1} and tr.ledger()["router_decisions"] == 2
    tr.unroute("r9")
    assert tr.ledger()["router_routed"] == {}
    tr.set_replicas([])
    with pytest.raises(RuntimeError, match="zero live replicas"):
        tr.route(tserving.ServeRequest(prompt=[1] * 16))


def test_the_default_load_reads_the_replicas_live_gauges(monkeypatch):
    client = ttelemetry.StatsdClient("t-fleet")
    client.gauge("serve_queue_depth", 9, tags=["engine:r0"])
    client.gauge("serve_queue_depth", 1, tags=["engine:r1"])
    router = tfleet.PrefixAffinityRouter(["r0", "r1"], block_size=8, client=client,
                                         spill_threshold=4)
    assert router._load("r0") == 9.0 and router._load("r2") == 0.0
    prompt = next(p for p in ([i] * 16 for i in range(50))
                  if router.rank(tfleet.affinity_key(p, 8, 2))[0] == "r0")
    assert router.route(tserving.ServeRequest(prompt=prompt)) == ("r1", True)


# ------------------------------------------------------------- local drive

@pytest.fixture(scope="module")
def models():
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    jparams = jllama.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.config("tiny", dtype="float32")
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    return {"jax": (jserving, jfleet, jllama.forward_decode, jparams, jcfg),
            "torch": (tserving, tfleet, tllama.forward_decode, tparams, tcfg)}


class FakeClock:
    """Ticks 1 ms at every read: equal stamps need equal reads, in order."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.001
        return self.t

    def sleep(self, s: float) -> None:
        self.t += float(s)


ENGINE = dict(batch_size=2, max_len=96, chunk=4, prefill_chunk=3, kv_block_size=8)
# the per-replica keys that divide by a clock reading (compared to 1e-3)
CLOCKED = ("wall_s", "tokens_per_sec", "busy_s")


def _fleet_queue():
    rng = np.random.RandomState(4)
    q = [(p, int(rng.randint(3, 7)), pri) for p, pri in _family_prompts(rng, 3, 3)]
    q.append((rng.randint(0, 256, size=5).tolist(), 4, 0))  # a sub-two-block prompt
    return q


def _drive(side, models, n, slo_s=0.0, queue=None):
    serving, fleet, fwd, params, cfg = models[side]
    clk = FakeClock()
    engines = {f"r{i}": serving.ServingEngine(fwd, params, cfg, clock=clk,
                                              gauge_tags=[f"engine:r{i}"], **ENGINE)
               for i in range(n)}
    router = fleet.PrefixAffinityRouter(list(engines), block_size=8, affinity_depth=2,
                                        spill_threshold=2, seed=1)
    reqs = [serving.ServeRequest(prompt=p, max_new_tokens=m, priority=pri)
            for p, m, pri in (queue or _fleet_queue())]
    beats = []

    def heartbeat(c):
        beats.append(c)
        clk.sleep(0.05)

    results, metrics = fleet.serve_fleet_local(engines, router, reqs, heartbeat=heartbeat,
                                               clock=clk, slo_s=slo_s)
    return reqs, results, metrics, beats


@pytest.mark.parametrize("n", [2, 3])
def test_serve_fleet_local_equals_the_jax_drive(models, n):
    jreqs, jres, jm, jbeats = _drive("jax", models, n, slo_s=5.0)
    treqs, tres, tm, tbeats = _drive("torch", models, n, slo_s=5.0)
    assert [r.tokens for r in tres] == [[int(x) for x in r.tokens] for r in jres]
    assert ([(r.status, r.new_tokens, r.retries, r.queue_s, r.ttft_s) for r in tres]
            == [(r.status, r.new_tokens, r.retries, r.queue_s, r.ttft_s) for r in jres])
    assert all(r.status == "ok" for r in tres) and tbeats == jbeats
    # the caller's requests are not mutated by the journey stamping
    assert all(r.journey == "" for r in treqs)
    jm, tm = _plain(jm), _plain(tm)
    jper, tper = jm.pop("fleet_per_replica"), tm.pop("fleet_per_replica")
    assert set(tper) == set(jper) == {f"r{i}" for i in range(n)}
    for rid in tper:
        keys = [k for k in jper[rid] if k not in CLOCKED]
        assert {k: tper[rid].get(k) for k in keys} == {k: jper[rid][k] for k in keys}, rid
        for k in CLOCKED:
            assert tper[rid][k] == pytest.approx(jper[rid][k], abs=1e-3), (rid, k)
        if tper[rid]["requests"]:
            assert tper[rid]["kv_allocated_blocks_final"] == 0
    for key in ("journeys", "fleet_decision_log"):
        assert tm[key] == jm[key], key
    for key in ("fleet_busy_max_s", "fleet_busy_sum_s", "fleet_wall_max_s", "tokens_per_sec",
                "fleet_goodput_tok_s"):
        assert tm.pop(key) == pytest.approx(jm.pop(key), abs=1e-3), key
    assert tm == jm
    assert tm["fleet_replicas"] == n and tm["router_decisions"] == len(treqs)
    assert sum(1 for rid in tper if tper[rid]["requests"]) >= 2
    assert tm["fleet_prefix_hit_tokens"] > 0


def test_journeys_and_the_decision_log_match_the_golden_schema(models):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["fleet_event_fields"] == {
        k: ["seq", "t", "kind"] + list(v) for k, v in tobs.FLEET_EVENT_FIELDS.items()}
    assert golden["journey_entry_fields"] == list(tobs.JOURNEY_ENTRY_FIELDS)
    assert golden["journey_leg_fields"] == list(tobs.JOURNEY_LEG_FIELDS)
    reqs, results, m, _ = _drive("torch", models, 2)
    jd, log = m["journeys"], m["fleet_decision_log"]
    assert jd["schema_version"] == golden["journey_schema_version"]
    assert log["schema_version"] == golden["fleet_log_schema_version"]
    assert tobs.validate_journey(jd) == [] == jobs.validate_journey(jd)
    assert tobs.validate_fleet_log(log) == [] == jobs.validate_fleet_log(log)
    for ev in log["events"]:
        assert list(ev) == golden["fleet_event_fields"][ev["kind"]]
    by_req = {rec["request"]: rec for rec in jd["journeys"]}
    assert len(by_req) == len(reqs)
    for i, res in enumerate(results):
        rec = by_req[i]
        assert list(rec) == golden["journey_entry_fields"] and rec["journey"] == f"j{i}"
        [leg] = rec["legs"]
        assert list(leg) == golden["journey_leg_fields"]
        att = tobs.journey_attribution(rec)
        assert att["latency_s"] == pytest.approx(res.latency_s)
        assert att["committed_tokens"] == res.new_tokens


def test_validators_flag_journey_and_log_drift(models):
    _, _, m, _ = _drive("torch", models, 2)
    jd, log = m["journeys"], m["fleet_decision_log"]
    bad = copy.deepcopy(jd)
    bad["journeys"][0]["legs"][0]["extra"] = 1
    assert tobs.validate_journey(bad) and tobs.validate_journey(bad) == jobs.validate_journey(bad)
    bad = copy.deepcopy(jd)
    bad["journeys"][0]["legs"][0]["timeline"][-1]["kind"] = "first_token"
    bad["journeys"][0]["legs"][0]["timeline"][-1].pop("status")
    assert tobs.validate_journey(bad) == jobs.validate_journey(bad) != []
    bad = copy.deepcopy(log)
    bad["events"][1]["seq"] = 0
    assert tobs.validate_fleet_log(bad) == jobs.validate_fleet_log(bad) != []
    # a seam that loses tokens across a drain
    seam = {"schema_version": 1, "journeys": [{"journey": "j0", "request": 0, "legs": [
        {"replica": "r0", "t_start": 0.0, "timeline": [
            {"kind": "enqueued", "t": 0.0, "prompt_tokens": 4, "max_new_tokens": 8},
            {"kind": "drained", "t": 0.1, "committed_tokens": 3, "admitted": True}]},
        {"replica": "r1", "t_start": 0.2, "timeline": [
            {"kind": "enqueued", "t": 0.0, "prompt_tokens": 6, "max_new_tokens": 5},
            {"kind": "terminal", "t": 0.1, "status": "ok", "new_tokens": 5,
             "latency_s": 0.1, "finished_by_stop": False}]}]}]}
    problems = tobs.validate_journey(seam)
    assert problems == jobs.validate_journey(seam) and "seam" in problems[0]
    assert tobs.journey_attribution(seam["journeys"][0]) == \
        jobs.journey_attribution(seam["journeys"][0])


def test_journeys_never_change_tokens(models):
    serving, fleet, fwd, params, cfg = models["torch"]
    reqs = [serving.ServeRequest(prompt=p, max_new_tokens=m) for p, m, _ in _fleet_queue()]
    out = []
    for kw in ({}, dict(journeys=False, decision_log=False)):
        engines = {f"r{i}": serving.ServingEngine(fwd, params, cfg, **ENGINE) for i in range(2)}
        router = fleet.PrefixAffinityRouter(list(engines), block_size=8)
        res, m = fleet.serve_fleet_local(engines, router, reqs, **kw)
        out.append((res, m))
        assert router.decision_log is None
    assert "journeys" not in out[1][1] and "fleet_decision_log" not in out[1][1]
    assert [r.tokens for r in out[0][0]] == [r.tokens for r in out[1][0]]


# ------------------------------------------------------------- SLO, gauges

def test_goodput_and_slo_verdicts_give_the_jax_numbers(models):
    _, results, m, _ = _drive("torch", models, 2)
    results = list(results) + [
        tserving.ServeResult(tokens=[1], new_tokens=0, finished_by_stop=False, latency_s=0.3,
                             status="shed"),
        tserving.ServeResult(tokens=[1, 2], new_tokens=7, finished_by_stop=False, latency_s=0.2,
                             status="failed_over", retries=1)]
    for slo in (0.05, 0.3, 10.0):
        got = tobs.goodput_under_slo(results, slo, 1.7)
        assert got == jobs.goodput_under_slo(results, slo, 1.7)
        verdicts = tobs.slo_verdicts(m["journeys"], slo)
        assert verdicts == jobs.slo_verdicts(m["journeys"], slo)
    assert tobs.goodput_under_slo(results, 10.0, 1.7)["slo_attainment"] == pytest.approx(
        (len(results) - 1) / len(results), abs=1e-4)


def test_fleet_gauges_give_the_jax_rollups():
    snaps = []
    for tele, obs in ((ttelemetry, tobs), (jtelemetry, jobs)):
        client = tele.StatsdClient("fleet-t")
        for i, rid in enumerate(("r0", "r1", "r2")):
            if rid == "r2":
                continue  # never published: skipped, not counted as zero
            client.gauge("serve_queue_depth", 3 + i, tags=[f"engine:{rid}"])
            client.gauge("serve_free_pool_blocks", 10 * (i + 1), tags=[f"engine:{rid}"])
            client.gauge("serve_committed_tokens", 100 + i, tags=[f"engine:{rid}"])
        fg = obs.FleetGauges(client=client, tags=["fleet:t"], slo_s=0.5)
        draws = np.random.RandomState(2)
        for _ in range(30):
            fg.observe_result(float(draws.exponential(0.2)), float(draws.exponential(0.4)),
                              bool(draws.rand() < 0.8))
        fg.publish(["r0", "r1", "r2"], stamp=4)
        snaps.append((client.snapshot(), obs.fleet_rollup(["r0", "r1", "r2"], client),
                      obs.render_prometheus(client)))
    assert snaps[0] == snaps[1]
    gauges = snaps[0][0]["gauges"]
    assert gauges["fleet-t.fleet_queue_depth_total"] == 7.0
    assert gauges["fleet-t.fleet_replicas_alive"] == 3
    assert "fleet-t.fleet_slo_attainment" in gauges


def test_the_planner_requeues_and_stitches_like_jax():
    reqs_t = [tserving.ServeRequest(prompt=[1, 2, 3], max_new_tokens=8, deadline_s=2.0,
                                    priority=1),
              tserving.ServeRequest(prompt=[4, 5], max_new_tokens=6, journey="keep")]
    reqs_j = [jserving.ServeRequest(prompt=[1, 2, 3], max_new_tokens=8, deadline_s=2.0,
                                    priority=1),
              jserving.ServeRequest(prompt=[4, 5], max_new_tokens=6, journey="keep")]
    out = []
    for fo, serving, reqs in ((tfailover, tserving, reqs_t), (jfailover, jserving, reqs_j)):
        planner = fo.ServeFailoverPlanner()
        gen0 = planner.fresh(reqs)
        drained = [serving.DrainedRequest(request_idx=0, committed=[7, 8], admitted=True,
                                          elapsed_s=0.5),
                   serving.DrainedRequest(request_idx=1, elapsed_s=0.5)]
        gen1 = planner.requeue(gen0, drained)
        done = serving.ServeResult(tokens=[1, 2, 3, 7, 8, 9], new_tokens=1,
                                   finished_by_stop=False, latency_s=0.25, status="ok",
                                   retries=1)
        stitched = planner.stitch(gen1[0], done)
        out.append(([(e.request_idx, e.request.journey) for e in gen0],
                    [(e.request_idx, list(e.request.prompt), e.request.max_new_tokens,
                      e.request.deadline_s, e.request.retries, e.request.journey, e.committed,
                      e.elapsed_s) for e in gen1],
                    (stitched.status, stitched.new_tokens, stitched.latency_s,
                     stitched.retries)))
    assert out[0] == out[1]
    assert out[0][2] == ("failed_over", 3, 0.75, 1)
    assert reqs_t[0].journey == ""  # fresh() stamps copies


# -------------------------------------------------------------- entry point

def _fleet_spec():
    return {"mode": "serve", "model": {"family": "llama", "preset": "tiny",
                                       "overrides": {"dtype": "float32"}},
            "train": {"batchSize": 2, "seqLen": 64, "seed": 0},
            "serve": {"numRequests": 8, "promptLengthMin": 20, "promptLengthMax": 30,
                      "sharedPrefixLength": 16, "maxNewMin": 3, "maxNewMax": 6, "chunk": 4,
                      "kvBlockSize": 8, "replicas": 2, "affinityDepth": 2,
                      "spillThreshold": 2, "autoscaleMin": 1, "autoscaleMax": 3}}


def test_the_fleet_entry_point_follows_the_jax_entry_point(monkeypatch, tmp_path):
    spec = _fleet_spec()
    assert tspec.JaxXlaRuntime.from_dict(spec).validate() == []
    monkeypatch.setenv("NEXUS_SERVE_TRACE", str(tmp_path / "t.json"))
    got = tentry.run_template_runtime(spec, device="cpu")
    tjourneys = json.loads((tmp_path / "t.json").read_text())
    tlog = json.loads((tmp_path / "t.json.fleetlog.json").read_text())
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    monkeypatch.setenv("NEXUS_SERVE_TRACE", str(tmp_path / "j.json"))
    ref = jrun(jspec.JaxXlaRuntime.from_dict(dict(spec, tpu={"accelerator": "v5e",
                                                             "topology": "1x1"})))
    jjourneys = json.loads((tmp_path / "j.json").read_text())
    jlog = json.loads((tmp_path / "j.json.fleetlog.json").read_text())
    # the keys the weights do not move (the packages draw different random
    # weights; no stop token, so every request runs its whole budget)
    for key in ("fleet_replicas", "committed_tokens", "fleet_committed_tokens",
                "fleet_prefix_hit_tokens", "router_policy", "router_decisions", "router_spills",
                "router_routed", "fleet_journeys", "fleet_decision_events", "finished_requests",
                "fleet_autoscale_active", "interrupted"):
        assert got[key] == ref[key], key
    assert "journeys" not in got and "fleet_decision_log" not in got
    assert got["fleet_journeys"] == 8 and got["fleet_autoscale_active"] is False
    assert got["committed_tokens"] == got["budget_tokens"]
    assert tobs.validate_journey(tjourneys) == [] and tobs.validate_fleet_log(tlog) == []
    # the same routes, and the same journeys up to their times
    strip = ("t", "t_start", "queue_s", "latency_s", "ttft_s")

    def shape(x):
        if isinstance(x, dict):
            return {k: shape(v) for k, v in x.items() if k not in strip}
        if isinstance(x, list):
            return [shape(v) for v in x]
        return x

    assert shape(tjourneys) == shape(jjourneys) and shape(tlog) == shape(jlog)


def test_a_single_engine_entry_tags_its_gauges_with_the_replica_id(monkeypatch):
    spec = _fleet_spec()
    spec["serve"] = dict(spec["serve"], replicas=1, numRequests=3)
    monkeypatch.setattr(ttelemetry, "_default_client", ttelemetry.StatsdClient())
    monkeypatch.setenv("NEXUS_SERVE_REPLICA_ID", "serve-3")
    m = tentry.run_template_runtime(spec, device="cpu")
    assert m["serve_replica_id"] == "serve-3" and m["live_gauge_publishes"] > 0
    assert 'nexus_tpu_serve_queue_depth{engine="serve-3"}' in tobs.render_prometheus()
