"""Cross-replica request journeys of the serve fleet (the port's copy of
``nexus_tpu/obs/journey.py``).

A fleet numbers each request once (the failover planner stamps the
journey id ``j<queue index>`` on ``ServeRequest.journey``), while each
engine's serve call numbers its own batch. :class:`JourneyBook` stitches
the per-call tracer dumps back into one record per request:

* a **leg** is one engine call's span timeline for the journey (the
  :class:`~nexus_tpu_torch.obs.trace.ServeTracer` spans verbatim), tagged
  with the replica and the call's start on the fleet's clock (span ``t``
  stays engine-local);
* the **seam invariant**: a requeued generation's prompt is the prior
  generation's prompt plus its drained committed tokens, so
  ``enqueued[k+1].prompt_tokens == enqueued[k].prompt_tokens +
  drained[k].committed_tokens``; :func:`validate_journey` checks it.

Then the SLO accounting: :func:`journey_attribution` splits a journey's
latency into queue, requeue and decode time, :func:`slo_verdicts` judges
each journey against an SLO, and :func:`goodput_under_slo` is the fleet
rollup over stitched results. Host dict bookkeeping only; no clock reads
(callers stamp ``t_start``). The schema is pinned by
``tests/golden/fleet_obs_schema.json``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from nexus_tpu_torch.obs.trace import SPAN_FIELDS

JOURNEY_SCHEMA_VERSION = 1

#: key order of one journey entry of a dump
JOURNEY_ENTRY_FIELDS = ("journey", "request", "legs")

#: key order of one leg: ``timeline`` is a list of tracer spans
#: (engine-local ``t``), ``t_start`` the call's start on the fleet clock
JOURNEY_LEG_FIELDS = ("replica", "t_start", "timeline")


class JourneyBook:
    """Stitch per-serve-call tracer dumps into cross-replica journeys.

    After every engine ``serve()`` call the fleet absorbs that call's
    tracer dump with the replica id, the call's start on the fleet clock
    and the original queue index of each batch entry; entries whose
    timeline carries a journey id join that journey as its next leg."""

    def __init__(self) -> None:
        self._journeys: Dict[str, dict] = {}
        self.legs_absorbed = 0

    def absorb_trace(self, trace_dump: dict, replica: str, t_start: float,
                     request_idxs: Sequence[int]) -> int:
        """Fold one call's tracer dump in → legs added. ``request_idxs[i]``
        is the original queue index of the call's i-th request; entries
        without a journey id are skipped."""
        added = 0
        for entry in trace_dump.get("spans", []):
            jid = str(entry.get("journey", "") or "")
            if not jid:
                continue
            i = int(entry.get("request", 0))
            idx = int(request_idxs[i]) if i < len(request_idxs) else i
            rec = self._journeys.get(jid)
            if rec is None:
                rec = {"journey": jid, "request": idx, "legs": []}
                self._journeys[jid] = rec
            rec["legs"].append({
                "replica": str(replica),
                "t_start": round(float(t_start), 6),
                "timeline": list(entry.get("timeline", [])),
            })
            added += 1
        self.legs_absorbed += added
        return added

    def journey_ids(self) -> List[str]:
        return list(self._journeys)

    def to_dict(self, only: Optional[Sequence[str]] = None) -> dict:
        """The journey dump (``only``: a cohort of journey ids)."""
        keep = None if only is None else set(only)
        return {
            "schema_version": JOURNEY_SCHEMA_VERSION,
            "journeys": [
                {"journey": rec["journey"], "request": rec["request"],
                 "legs": [dict(leg) for leg in rec["legs"]]}
                for rec in self._journeys.values()
                if keep is None or rec["journey"] in keep
            ],
        }


def _leg_problems(jid: str, k: int, leg: dict, final: bool, problems: List[str]) -> None:
    got = tuple(leg.keys())
    if got != JOURNEY_LEG_FIELDS:
        problems.append(f"journey {jid} leg {k}: keys {got} != {JOURNEY_LEG_FIELDS}")
        return
    tl = leg.get("timeline") or []
    if not tl:
        problems.append(f"journey {jid} leg {k}: empty timeline")
        return
    last_t: Optional[float] = None
    for j, span in enumerate(tl):
        kind = span.get("kind")
        if kind not in SPAN_FIELDS:
            problems.append(f"journey {jid} leg {k} span {j}: unknown kind {kind!r}")
            continue
        expect = ("kind",) + SPAN_FIELDS[kind]
        if tuple(span.keys()) != expect:
            problems.append(f"journey {jid} leg {k} span {j} ({kind}): fields "
                            f"{tuple(span.keys())} != schema {expect}")
        t = span.get("t")
        if not isinstance(t, (int, float)):
            problems.append(f"journey {jid} leg {k} span {j} ({kind}): t not a number")
        elif last_t is not None and t < last_t:
            problems.append(f"journey {jid} leg {k} span {j} ({kind}): t went "
                            f"backwards ({last_t} -> {t})")
        else:
            last_t = t
    if tl[0].get("kind") != "enqueued":
        problems.append(f"journey {jid} leg {k}: timeline does not start 'enqueued'")
    end = tl[-1].get("kind")
    if final:
        if end not in ("terminal", "drained"):
            problems.append(f"journey {jid} final leg {k} ends {end!r}, not "
                            "terminal/drained")
    elif end != "drained":
        problems.append(f"journey {jid} non-final leg {k} ends {end!r}, not "
                        "'drained' (only a drain hands a journey to the next leg)")


def validate_journey(dump: dict) -> List[str]:
    """Schema and stitching check of a :meth:`JourneyBook.to_dict` dump →
    problems (empty = valid): the key orders, each leg's spans, every
    non-final leg ending ``drained``, ``t_start`` never decreasing, and
    the token-conserving seam between legs."""
    problems: List[str] = []
    if dump.get("schema_version") != JOURNEY_SCHEMA_VERSION:
        problems.append(f"schema_version {dump.get('schema_version')!r} != "
                        f"{JOURNEY_SCHEMA_VERSION}")
    journeys = dump.get("journeys")
    if not isinstance(journeys, list):
        problems.append("journeys is not a list")
        return problems
    for rec in journeys:
        got = tuple(rec.keys())
        if got != JOURNEY_ENTRY_FIELDS:
            problems.append(f"journey entry keys {got} != {JOURNEY_ENTRY_FIELDS}")
            continue
        jid = rec.get("journey")
        legs = rec.get("legs") or []
        if not legs:
            problems.append(f"journey {jid}: no legs")
            continue
        last_start: Optional[float] = None
        for k, leg in enumerate(legs):
            _leg_problems(jid, k, leg, final=(k == len(legs) - 1), problems=problems)
            ts = leg.get("t_start")
            if isinstance(ts, (int, float)):
                if last_start is not None and ts < last_start:
                    problems.append(f"journey {jid} leg {k}: t_start went backwards "
                                    f"({last_start} -> {ts})")
                else:
                    last_start = ts
        # the seam: committed tokens conserved across every handoff
        for k in range(len(legs) - 1):
            a = (legs[k].get("timeline") or [{}])
            b = (legs[k + 1].get("timeline") or [{}])
            if (a[0].get("kind") != "enqueued" or b[0].get("kind") != "enqueued"
                    or a[-1].get("kind") != "drained"):
                continue  # already reported above
            expect = int(a[0].get("prompt_tokens", 0)) + int(a[-1].get("committed_tokens", 0))
            got_p = int(b[0].get("prompt_tokens", 0))
            if got_p != expect:
                problems.append(f"journey {jid} seam {k}->{k + 1}: prompt_tokens {got_p} != "
                                f"prior prompt + drained committed ({expect}) — tokens lost or "
                                "re-decoded across the failover")
    return problems


# --------------------------------------------------------- SLO accounting

def _leg_queue_s(tl: List[dict]) -> Optional[float]:
    for span in tl:
        if span.get("kind") == "admitted":
            return float(span.get("queue_s", 0.0))
    return None  # never admitted on this leg


def journey_attribution(rec: dict) -> Dict[str, float]:
    """One journey entry → ``{"queue_s", "requeue_s", "decode_s",
    "latency_s", "committed_tokens", "status"}``; ``latency_s`` is the
    bucket sum."""
    queue = requeue = decode = 0.0
    committed = 0
    status = ""
    legs = rec.get("legs") or []
    for k, leg in enumerate(legs):
        tl = leg.get("timeline") or []
        if not tl:
            continue
        final = k == len(legs) - 1
        end = tl[-1]
        leg_total = float(end.get("t", 0.0))
        q = _leg_queue_s(tl)
        if end.get("kind") == "drained":
            committed += int(end.get("committed_tokens", 0))
            if q is None:
                queue += leg_total  # drained out of the wait queue
            else:
                queue += q
                requeue += max(0.0, leg_total - q)
        elif end.get("kind") == "terminal":
            status = str(end.get("status", ""))
            committed += int(end.get("new_tokens", 0))
            leg_total = float(end.get("latency_s", leg_total))
            if q is None:
                queue += leg_total  # shed / queued deadline: all wait
            else:
                queue += q
                decode += max(0.0, leg_total - q)
        if final and end.get("kind") == "drained":
            status = "drained"  # an interrupted dump: the journey is open
    return {
        "queue_s": round(queue, 6),
        "requeue_s": round(requeue, 6),
        "decode_s": round(decode, 6),
        "latency_s": round(queue + requeue + decode, 6),
        "committed_tokens": committed,
        "status": status,
    }


def slo_verdicts(dump: dict, slo_s: float) -> List[dict]:
    """Per journey: the attribution buckets plus ``journey``, ``request``,
    ``replicas``, ``migrations`` and ``slo_attained``."""
    out: List[dict] = []
    for rec in dump.get("journeys", []):
        att = journey_attribution(rec)
        legs = rec.get("legs") or []
        out.append({
            "journey": rec.get("journey"),
            "request": rec.get("request"),
            "replicas": [leg.get("replica") for leg in legs],
            "migrations": max(0, len(legs) - 1),
            **att,
            "slo_attained": bool(att["status"] == "ok" and att["latency_s"] <= float(slo_s)),
        })
    return out


def goodput_under_slo(results: Sequence[Any], slo_s: float, wall_s: float) -> Dict[str, float]:
    """Goodput under an SLO over stitched ``ServeResult``s: the tokens of
    requests that finished ``ok`` (or ``failed_over``) within ``slo_s``,
    over the serve wall, and the share of finished requests that did."""
    finished = [r for r in results if r is not None]
    ok = [r for r in finished if getattr(r, "status", "") in ("ok", "failed_over")]
    attained = [r for r in ok if float(r.latency_s) <= float(slo_s)]
    return {
        "slo_s": round(float(slo_s), 6),
        "slo_attainment": round(len(attained) / max(1, len(finished)), 4),
        "goodput_tok_s": round(sum(int(r.new_tokens) for r in attained)
                               / max(1e-9, float(wall_s)), 2),
        "ok_under_slo": len(attained),
    }
