"""The fleet decision log: what the router decided and why (the port's
copy of ``nexus_tpu/obs/fleet_log.py``).

:class:`FleetDecisionLog` records each decision with its evidence: for a
``route``, the affinity key, the rendezvous ranking, the candidate loads
the power-of-two choice compared and the chosen replica. The other event
kinds (scale decisions, replica lifecycle, drains) belong to the live
fleet harness and are kept in the schema so dumps validate alike. A
bounded ring; ``t`` comes from the clock its owner injects; the schema
(field names and order) is :data:`FLEET_EVENT_FIELDS`, pinned by
``tests/golden/fleet_obs_schema.json``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

FLEET_LOG_SCHEMA_VERSION = 1

#: Event kinds and their fields, in emission order: every event is
#: ``{"seq", "t", "kind"}`` followed by exactly these fields.
FLEET_EVENT_FIELDS: Dict[str, tuple] = {
    # one routing decision: key is the affinity digest (hex prefix),
    # ranked the candidate order, loads the spill-over signal read
    "route": ("journey", "key", "policy", "ranked", "loads", "chosen",
              "spilled", "spill_threshold"),
    # one autoscaler poll and its per-replica evidence
    "scale_decision": ("current", "target", "reason", "breach_streak",
                       "clear_streak", "stale", "samples"),
    # replica lifecycle
    "spawn": ("replica",),
    "kill": ("replica", "hard"),
    "death_confirmed": ("replica", "detection_s", "fenced_alive"),
    # the journeys that left a replica on a drain
    "drain": ("replica", "reason", "journeys"),
}


class FleetDecisionLog:
    """Bounded audit ring of fleet decisions. ``t`` is seconds since the
    log's construction on ``clock``; every append and read holds
    ``_lock``."""

    def __init__(self, capacity: int = 4096, max_dumps: int = 8,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self.dumps: deque = deque(maxlen=int(max_dumps))
        self.last_dump: Optional[dict] = None

    def record(self, kind: str, **fields) -> None:
        """Append one decision; ``fields`` must hold
        ``FLEET_EVENT_FIELDS[kind]``. The clock is read inside the lock, so
        the ring's time axis follows its seq order."""
        with self._lock:
            t = round(self._clock() - self._t0, 6)
            ev = {"seq": self._seq, "t": t, "kind": kind}
            for f in FLEET_EVENT_FIELDS[kind]:
                ev[f] = fields[f]
            self._seq += 1
            self._ring.append(ev)

    @property
    def events_recorded(self) -> int:
        with self._lock:
            return self._seq

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._ring)
        if kind is None:
            return evs
        return [e for e in evs if e["kind"] == kind]

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "schema_version": FLEET_LOG_SCHEMA_VERSION,
                "events_recorded": self._seq,
                "events": [dict(e) for e in self._ring],
            }

    def trip(self, reason: str, detail: Optional[dict] = None,
             journeys: Optional[dict] = None) -> dict:
        """Freeze the ring (with the affected cohort's journey dump) into a
        fleet postmortem."""
        with self._lock:
            t = round(self._clock() - self._t0, 6)
            dump = {
                "schema_version": FLEET_LOG_SCHEMA_VERSION,
                "reason": reason,
                "tripped_t": t,
                "detail": dict(detail or {}),
                "events": [dict(e) for e in self._ring],
                "journeys": dict(journeys or {"journeys": []}),
            }
        self.dumps.append(dump)
        self.last_dump = dump
        return dump


def validate_fleet_log(dump: dict) -> List[str]:
    """Schema check of a :meth:`FleetDecisionLog.to_dict` (or ``trip``)
    dump → problems (empty = valid): the version, known kinds with keys
    exactly ``("seq", "t", "kind") + FLEET_EVENT_FIELDS[kind]`` in order,
    ``seq`` strictly increasing, ``t`` numeric and non-decreasing, and a
    reason on a trip dump."""
    problems: List[str] = []
    if dump.get("schema_version") != FLEET_LOG_SCHEMA_VERSION:
        problems.append(f"schema_version {dump.get('schema_version')!r} != "
                        f"{FLEET_LOG_SCHEMA_VERSION}")
    if "tripped_t" in dump and not dump.get("reason"):
        problems.append("trip dump missing reason")
    events = dump.get("events")
    if not isinstance(events, list):
        problems.append("events is not a list")
        return problems
    last_seq = -1
    last_t: Optional[float] = None
    for ev in events:
        kind = ev.get("kind")
        if kind not in FLEET_EVENT_FIELDS:
            problems.append(f"event seq={ev.get('seq')}: unknown kind {kind!r}")
            continue
        expect = ("seq", "t", "kind") + FLEET_EVENT_FIELDS[kind]
        got = tuple(ev.keys())
        if got != expect:
            problems.append(f"event seq={ev.get('seq')} ({kind}): fields {got} != "
                            f"schema {expect}")
        seq = ev.get("seq")
        if not isinstance(seq, int) or seq <= last_seq:
            problems.append(f"event seq {seq!r} not strictly increasing after {last_seq}")
        else:
            last_seq = seq
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            problems.append(f"event seq={seq}: t is not a number")
        elif last_t is not None and t < last_t:
            problems.append(f"event seq={seq}: t went backwards ({last_t} -> {t})")
        else:
            last_t = t
    return problems
