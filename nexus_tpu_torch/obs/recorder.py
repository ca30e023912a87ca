"""Flight recorder: a bounded ring of the engine's recent wave events (the
port's copy of ``nexus_tpu/obs/recorder.py``).

The engine appends one compact event per wave boundary (and admission,
shed, deadline and drain events as they happen); nothing is kept past
``capacity`` events. :meth:`FlightRecorder.trip` freezes a JSON-safe
snapshot of the recent past, stamped with its reason. The engine trips it
when an in-loop sanitizer audit fails, when one wave boundary ends at
least ``storm_threshold`` requests by shedding or deadline, and when it is
drained. The recorder reads no clock: the engine stamps every event.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, List, Optional

FLIGHT_SCHEMA_VERSION = 1

#: the event kinds the engine records (every event also has seq and t)
FLIGHT_EVENT_KINDS = (
    "run_start",      # serve() entered its wave loop
    "wave",           # one decode-chunk boundary
    "admission",      # an admission wave placed >= 1 request
    "shed",           # a queued request shed
    "deadline",       # a request ended deadline_exceeded
    "drain_request",  # one request drained off the engine
    "run_end",        # serve() returned normally
)


class FlightRecorder:
    """Bounded ring of wave events, and trip-to-snapshot.

    ``record`` is the hot-path append; ``trip`` freezes the ring into a
    dump (kept in ``dumps``, itself a ring of ``max_dumps``, and in
    ``last_dump``). ``seq`` counts over the recorder's lifetime, so one
    recorder may follow an engine across serve() calls."""

    def __init__(self, capacity: int = 512, max_dumps: int = 16) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_dumps < 1:
            raise ValueError(f"max_dumps must be >= 1, got {max_dumps}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dumps: deque = deque(maxlen=int(max_dumps))
        self.last_dump: Optional[dict] = None

    def record(self, kind: str, t: float, **fields: Any) -> None:
        """Append one event (``t``: seconds since the run's start)."""
        ev = {"seq": self._seq, "t": round(float(t), 6), "kind": kind}
        ev.update(fields)
        self._seq += 1
        self._ring.append(ev)

    @property
    def events_recorded(self) -> int:
        """Events ever recorded (>= len(ring) once it wraps)."""
        return self._seq

    def tail(self, n: int = 16) -> List[dict]:
        """The most recent ``n`` events, oldest first."""
        if n <= 0:
            return []
        return list(self._ring)[-n:]

    def trip(self, reason: str, t: float, detail: Optional[dict] = None) -> dict:
        """Freeze the ring → dump (also appended to ``dumps``)."""
        dump = {
            "schema_version": FLIGHT_SCHEMA_VERSION,
            "reason": reason,
            "tripped_t": round(float(t), 6),
            "detail": dict(detail or {}),
            "events": list(self._ring),
        }
        self.dumps.append(dump)
        self.last_dump = dump
        return dump


def write_dump(dump: dict, path: str) -> str:
    """Write a trip dump as JSON (making parent directories) → ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(dump, f, indent=1, sort_keys=False)
        f.write("\n")
    return path


def validate_flight_dump(dump: dict) -> List[str]:
    """Schema check of a trip dump → problems (empty = valid): the
    version, a reason, known event kinds with strictly increasing ``seq``
    and numeric ``t``."""
    problems: List[str] = []
    if dump.get("schema_version") != FLIGHT_SCHEMA_VERSION:
        problems.append(f"schema_version {dump.get('schema_version')!r} != "
                        f"{FLIGHT_SCHEMA_VERSION}")
    if not dump.get("reason"):
        problems.append("missing trip reason")
    events = dump.get("events")
    if not isinstance(events, list):
        problems.append("events is not a list")
        return problems
    last_seq = -1
    for ev in events:
        kind = ev.get("kind")
        if kind not in FLIGHT_EVENT_KINDS:
            problems.append(f"event seq={ev.get('seq')}: unknown kind {kind!r}")
        seq = ev.get("seq")
        if not isinstance(seq, int) or seq <= last_seq:
            problems.append(f"event seq {seq!r} not strictly increasing after {last_seq}")
        else:
            last_seq = seq
        if not isinstance(ev.get("t"), (int, float)):
            problems.append(f"event seq={seq}: t is not a number")
    return problems
