"""Per-request span timelines of the serving engine (the port's copy of
``nexus_tpu/obs/trace.py``).

One :class:`ServeTracer` records one serve run: a list of spans per
request, appended by the engine at the host-side points where it already
touches per-row state (admission wave, the chunk boundary's commit loop,
release). A span is a plain dict, ``kind`` first, then the fields
:data:`SPAN_FIELDS` fixes for that kind in that order: the dump's field
names and order are a schema (``tests/golden/serve_trace_schema.json``).

The tracer never reads a clock: the engine stamps every event with ``t``
(seconds since the run's start on its own injectable clock), so a traced
run replays exactly on a fake clock. Nothing here touches a tensor.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

TRACE_SCHEMA_VERSION = 1

#: Span kinds and their fields, in emission order (``kind`` first). This
#: table IS the trace schema.
SPAN_FIELDS: Dict[str, tuple] = {
    # the request entered the engine's wait queue
    "enqueued": ("t", "prompt_tokens", "max_new_tokens"),
    # the request won a decode row; cache attribution of the admission
    "admitted": (
        "t", "row", "queue_s", "prompt_tokens", "budget",
        "matched_tokens", "shared_blocks", "restored_blocks",
        "cow_copy", "reserved_blocks",
    ),
    # one dispatch's chunked-prefill progress for the row
    "prefill_chunk": ("t", "row", "wave", "from_pos", "to_pos"),
    # the row's first committed token (the ttft observation)
    "first_token": ("t", "row", "wave", "ttft_s"),
    # one dispatch's committed decode tokens; accepted / rejected split
    # the speculative tiers (plain decode: accepted == tokens, 0)
    "decode_wave": ("t", "row", "wave", "tokens", "accepted", "rejected"),
    # the row's lease mapped more pool blocks this wave
    "lease_grow": ("t", "row", "wave", "blocks_mapped"),
    # terminal disposition (ok / deadline_exceeded / shed)
    "terminal": ("t", "status", "new_tokens", "latency_s",
                 "finished_by_stop"),
    # the engine was drained: the request lives on elsewhere with its
    # committed tokens
    "drained": ("t", "committed_tokens", "admitted"),
}


class ServeTracer:
    """Span timeline of one serve run, keyed by request index::

        tracer = ServeTracer()
        engine.serve(requests, tracer=tracer)  # or ServingEngine(tracer=)
        dump = tracer.to_dict()

    ``to_dict()`` gives ``{"schema_version": 1, "requests": N, "spans":
    [{"request": i, "timeline": [span, ...]}, ...]}`` (with a ``journey``
    per entry when the run's requests carried journey ids). Timelines are
    in emission order, which is time order per request. ``begin`` resets
    the tracer for the next run."""

    def __init__(self) -> None:
        self._timelines: List[List[dict]] = []
        self._journeys: List[str] = []
        self.runs = 0

    def begin(self, n_requests: int, journeys: Optional[List[str]] = None) -> None:
        """Reset for a run of ``n_requests``; ``journeys`` names each
        request's fleet-level journey id (``ServeRequest.journey``)."""
        n = int(n_requests)
        self._timelines = [[] for _ in range(n)]
        self._journeys = ([str(j or "") for j in journeys] if journeys is not None
                          else [""] * n)
        self.runs += 1

    def extend(self, journey: str = "") -> int:
        """Open a timeline for a request that arrived mid-run (a streamed
        arrival) → its request index."""
        self._timelines.append([])
        self._journeys.append(str(journey or ""))
        return len(self._timelines) - 1

    def event(self, request_idx: int, kind: str, **fields: Any) -> None:
        """Append one span; ``fields`` must hold ``SPAN_FIELDS[kind]``."""
        span = {"kind": kind}
        for f in SPAN_FIELDS[kind]:
            span[f] = fields[f]
        self._timelines[request_idx].append(span)

    def timeline(self, request_idx: int) -> List[dict]:
        return self._timelines[request_idx]

    def to_dict(self) -> dict:
        # entries carry "journey" only when the run was given journey ids
        journeys = any(self._journeys)
        return {
            "schema_version": TRACE_SCHEMA_VERSION,
            "requests": len(self._timelines),
            "spans": [
                ({"request": i, "journey": self._journeys[i], "timeline": list(tl)}
                 if journeys else {"request": i, "timeline": list(tl)})
                for i, tl in enumerate(self._timelines)
            ],
        }


def validate_trace(dump: dict) -> List[str]:
    """Schema check of a :meth:`ServeTracer.to_dict` dump → problems (empty
    = valid): the version, the top-level shape, known kinds, each span's
    keys exactly ``("kind",) + SPAN_FIELDS[kind]`` in order, ``t`` never
    decreasing within a request, and every non-empty timeline starting
    ``enqueued`` and ending ``terminal`` or ``drained``."""
    problems: List[str] = []
    if dump.get("schema_version") != TRACE_SCHEMA_VERSION:
        problems.append(f"schema_version {dump.get('schema_version')!r} != "
                        f"{TRACE_SCHEMA_VERSION}")
    spans = dump.get("spans")
    if not isinstance(spans, list):
        problems.append("spans is not a list")
        return problems
    for entry in spans:
        rid = entry.get("request")
        tl = entry.get("timeline", [])
        last_t: Optional[float] = None
        for j, span in enumerate(tl):
            kind = span.get("kind")
            if kind not in SPAN_FIELDS:
                problems.append(f"request {rid} span {j}: unknown kind {kind!r}")
                continue
            expect = ("kind",) + SPAN_FIELDS[kind]
            got = tuple(span.keys())
            if got != expect:
                problems.append(f"request {rid} span {j} ({kind}): fields {got} != "
                                f"schema {expect}")
            t = span.get("t")
            if not isinstance(t, (int, float)):
                problems.append(f"request {rid} span {j} ({kind}): t is not a number")
            elif last_t is not None and t < last_t:
                problems.append(f"request {rid} span {j} ({kind}): t went backwards "
                                f"({last_t} -> {t})")
            else:
                last_t = t
        if tl:
            if tl[0].get("kind") != "enqueued":
                problems.append(f"request {rid}: timeline does not start 'enqueued'")
            if tl[-1].get("kind") not in ("terminal", "drained"):
                problems.append(f"request {rid}: timeline ends {tl[-1].get('kind')!r}, not "
                                "terminal/drained")
    return problems
