"""The deterministic fleet drive (the port's copy of ``serve_fleet_local``
from ``nexus_tpu/fleet/fleet.py``; the live threaded ``ServeFleet``
harness is not ported).

:func:`serve_fleet_local` routes the whole queue through the
prefix-affinity router (priority order), serves each replica's partition
on its own engine, one replica after another, and merges the results back
into request order. The replicas stand for independent engines:
``fleet_busy_max_s`` and ``fleet_wall_max_s`` are the slowest replica's
serve time and compile-free wall (what N engines side by side would take),
beside the sum ``fleet_busy_sum_s``. Every replica call gets a fresh
tracer, stitched into one journey per request, and every route decision
lands in the decision log. Over a tensor-parallel mesh the replicas share
its tensor group (they serve one after another) and, when the engines run
in lockstep, the fleet's clock is rank 0's over their group, broadcast at
each read, as each engine's is.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from nexus_tpu_torch.fleet.router import PrefixAffinityRouter
from nexus_tpu_torch.ha.serve_failover import RequeueEntry, ServeFailoverPlanner
from nexus_tpu_torch.obs.fleet_log import FleetDecisionLog
from nexus_tpu_torch.obs.journey import JourneyBook, goodput_under_slo
from nexus_tpu_torch.obs.trace import ServeTracer
from nexus_tpu_torch.parallel.comm import AgreedClock


def serve_fleet_local(
    engines: Dict[str, Any],
    router: PrefixAffinityRouter,
    requests: Sequence[Any],
    cancel: Any = None,
    heartbeat: Optional[Callable[[int], None]] = None,
    planner: Optional[ServeFailoverPlanner] = None,
    clock: Callable[[], float] = time.monotonic,
    journeys: bool = True,
    decision_log: Any = None,
    slo_s: float = 0.0,
) -> Tuple[List[Optional[Any]], Dict[str, Any]]:
    """Route ``requests`` through ``router``, serve each replica's
    partition on ``engines[replica]`` → ``(results, metrics)``,
    ``results[i]`` answering ``requests[i]``.

    ``heartbeat`` gets the fleet's cumulative committed tokens at every
    wave boundary of every replica; a fired ``cancel`` drains the replica
    serving at its next boundary and starts no more. ``journeys`` stitches
    the per-call tracer dumps into ``metrics['journeys']``;
    ``decision_log`` (None: a fresh :class:`FleetDecisionLog`, False: off)
    lands in ``metrics['fleet_decision_log']``; ``slo_s`` > 0 adds the
    goodput-under-SLO rollup against the slowest replica's wall."""
    planner = planner or ServeFailoverPlanner()
    group = next((e.lockstep_group for e in engines.values() if e.lockstep_group is not None),
                 None)
    if group is not None and not isinstance(clock, AgreedClock):
        clock = AgreedClock(clock, group)
    t_run0 = clock()
    if decision_log is False:
        log = None
    else:
        log = decision_log or FleetDecisionLog(clock=clock)
    book = JourneyBook() if journeys else None
    if router._load_fn is None:
        # nothing has published a gauge during an upfront pass: the routed
        # counts are the load that exists
        router.enable_pending_load()
    entries = planner.fresh(requests)
    # our log rides on the router for this one routing pass only; a log
    # the caller attached stays as it is
    attached_log = log is not None and router.decision_log is None
    if attached_log:
        router.decision_log = log
    try:
        assignments = router.route_batch(entries)
    finally:
        if attached_log:
            router.decision_log = None
    partitions: Dict[str, List[RequeueEntry]] = {rid: [] for rid in engines}
    for entry, rid, _spilled in assignments:
        partitions[rid].append(entry)
    results: List[Optional[Any]] = [None] * len(requests)
    committed_total = [0]
    per_replica: Dict[str, Dict[str, Any]] = {}
    interrupted = False
    busy: List[float] = []
    walls: List[float] = []
    for rid, engine in engines.items():
        part = partitions.get(rid) or []
        if not part:
            per_replica[rid] = {"requests": 0, "busy_s": 0.0}
            busy.append(0.0)
            walls.append(0.0)
            continue
        base = committed_total[0]

        def hb(step, _base=base):
            committed_total[0] = _base + int(step)
            if heartbeat is not None:
                heartbeat(committed_total[0])

        call_tracer = ServeTracer() if book is not None else None
        t0 = clock()
        r_results, r_metrics = engine.serve([e.request for e in part], cancel=cancel,
                                            heartbeat=hb, tracer=call_tracer)
        busy_s = clock() - t0
        if book is not None:
            book.absorb_trace(call_tracer.to_dict(), replica=rid, t_start=t0 - t_run0,
                              request_idxs=[e.request_idx for e in part])
        busy.append(busy_s)
        # the engine's wall leaves its warm-up out
        walls.append(float(r_metrics.get("wall_s", busy_s) or 0.0))
        committed_total[0] = base + int(r_metrics.get("committed_tokens", 0) or 0)
        for entry, res in zip(part, r_results):
            if res is not None:
                results[entry.request_idx] = planner.stitch(entry, res)
        per_replica[rid] = {**r_metrics, "requests": len(part), "busy_s": round(busy_s, 6)}
        if r_metrics.get("interrupted"):
            interrupted = True
            break  # the cancel is fleet-wide
    busy_max = max(busy) if busy else 0.0
    wall_max = max(walls) if walls else 0.0
    metrics: Dict[str, Any] = {
        "fleet_replicas": len(engines),
        "fleet_committed_tokens": committed_total[0],
        "fleet_busy_max_s": round(busy_max, 6),
        "fleet_busy_sum_s": round(sum(busy), 6),
        "fleet_wall_max_s": round(wall_max, 6),
        "fleet_prefix_hit_tokens": sum(int(m.get("prefix_hit_tokens", 0) or 0)
                                       for m in per_replica.values()),
        "fleet_per_replica": per_replica,
        "interrupted": interrupted,
        # the single engine's names at fleet scope: tokens/s against the
        # slowest replica's compile-free wall
        "committed_tokens": committed_total[0],
        "tokens_per_sec": round(committed_total[0] / max(wall_max, 1e-9), 2),
        **router.ledger(),
    }
    if book is not None:
        metrics["journeys"] = book.to_dict()
    if log is not None:
        metrics["fleet_decision_log"] = log.to_dict()
    if slo_s > 0:
        g = goodput_under_slo([r for r in results if r is not None], slo_s, wall_max)
        metrics["fleet_slo_s"] = g["slo_s"]
        metrics["fleet_slo_attainment"] = g["slo_attainment"]
        metrics["fleet_goodput_tok_s"] = g["goodput_tok_s"]
    return results, metrics
