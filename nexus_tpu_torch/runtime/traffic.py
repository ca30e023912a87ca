"""Replayable arrival traces and the open-loop streaming source (a copy of
``nexus_tpu/runtime/traffic.py``, which is pure Python plus numpy; the port
keeps its own so that it imports nothing of the JAX package, and its
requests are the port's ``ServeRequest``).

A closed-loop queue hands every request to ``serve()`` at once, so the
engine-lifetime radix tree, block pool and host tier never face requests
that arrive over time, share prefixes across calls and queue under bursts.
This module gives a versioned, seed-replayable trace format and a
:class:`TraceSource` that streams it into a running ``serve()`` call
through the source protocol the engine polls at wave boundaries.

Design constraints, in order:

  1. **Replayable.** A trace is pure data (``to_dict``/``from_dict``
     round-trip exactly, ``trace_version`` pinned) and synthesis is
     PURE-SEEDED: :func:`synthesize_trace` never reads a clock or global
     RNG state, so the same ``(seed, knobs)`` always yields the same
     trace, byte for byte the JAX package's. Arrival times are
     trace-relative seconds; the wall clock enters only in
     :class:`TraceSource`, through an injectable sleep.
  2. **The shapes that matter.** Poisson and bursty (on/off clustered)
     arrivals; Zipf-shared prompt prefixes (a rank-``a`` power law over a
     pool of shared prefixes: system prompts, few-shot headers);
     multi-turn chat sessions (turn ``k+1``'s prompt is turn ``k``'s full
     history plus a fresh user message, after think time); agent-style
     fan-outs (N children sharing the parent's history, arriving
     together).
  3. **Honest chat history.** A successor turn's prompt contains the
     parent's COMPLETION only when ``completion_fn(prompt, budget)``
     supplies it; without it a seeded filler stands in (prefix reuse then
     stops at the prompt chain: still a valid trace, a shallower one).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

TRACE_VERSION = 1

#: Event kinds: a one-shot request, one turn of a chat session, or one
#: branch of an agent fan-out (the parent of a fan-out is kind
#: "single"; its children are "branch").
EVENT_KINDS = ("single", "turn", "branch")


@dataclass
class TraceEvent:
    """One arrival: WHEN (seconds from trace start) and WHAT (the
    request body). ``session`` groups the turns of one conversation or
    the members of one fan-out family; ``turn`` orders within it."""

    arrival_s: float
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    session: str = ""
    turn: int = 0
    kind: str = "single"

    def to_dict(self) -> dict:
        return {
            "arrival_s": round(float(self.arrival_s), 6),
            "prompt": [int(t) for t in self.prompt],
            "max_new_tokens": int(self.max_new_tokens),
            "temperature": float(self.temperature),
            "seed": int(self.seed),
            "session": str(self.session),
            "turn": int(self.turn),
            "kind": str(self.kind),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(
            arrival_s=float(d["arrival_s"]),
            prompt=[int(t) for t in d["prompt"]],
            max_new_tokens=int(d.get("max_new_tokens", 16)),
            temperature=float(d.get("temperature", 0.0)),
            seed=int(d.get("seed", 0)),
            session=str(d.get("session", "")),
            turn=int(d.get("turn", 0)),
            kind=str(d.get("kind", "single")),
        )


@dataclass
class Trace:
    """A versioned, replayable arrival trace: events sorted by
    ``arrival_s``, the seed and knobs that made them (``meta``), and
    the schema version the loader refuses to mis-read."""

    name: str
    seed: int
    events: List[TraceEvent] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    version: int = TRACE_VERSION

    @property
    def duration_s(self) -> float:
        return self.events[-1].arrival_s if self.events else 0.0

    def __len__(self) -> int:
        return len(self.events)

    def to_dict(self) -> dict:
        return {
            "trace_version": int(self.version),
            "name": str(self.name),
            "seed": int(self.seed),
            "meta": dict(self.meta),
            "events": [ev.to_dict() for ev in self.events],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        v = int(d.get("trace_version", -1))
        if v != TRACE_VERSION:
            raise ValueError(
                f"trace_version {v} != supported {TRACE_VERSION}"
            )
        return cls(
            name=str(d.get("name", "")),
            seed=int(d.get("seed", 0)),
            meta=dict(d.get("meta", {})),
            events=[TraceEvent.from_dict(e) for e in d.get("events", [])],
            version=v,
        )

    def to_requests(self, deadline_s: float = 0.0,
                    arrivals: bool = False) -> List[Any]:
        """Materialize the trace as a CLOSED-LOOP queue of the port's
        ``ServeRequest`` (the whole queue exists at ``serve()`` entry),
        in the order a ``TraceSource`` delivers it. ``arrivals=True``
        keeps the trace arrival stamps on the requests, so a closed-
        loop call still attributes queue time from trace arrival."""
        from nexus_tpu_torch.runtime.serving import ServeRequest

        return [
            ServeRequest(
                prompt=list(ev.prompt),
                max_new_tokens=ev.max_new_tokens,
                temperature=ev.temperature,
                seed=ev.seed,
                deadline_s=deadline_s,
                arrival_s=(float(ev.arrival_s) if arrivals else 0.0),
            )
            for ev in self.events
        ]


# ------------------------------------------------------------- synthesis

def _zipf_probs(n: int, a: float) -> List[float]:
    """Rank power-law p_k ∝ 1/k^a over ranks 1..n, normalized.
    Explicit probabilities (not ``rng.zipf``) so the support is exactly
    the prefix pool — no unbounded draws to clip, replay-stable."""
    raw = [1.0 / float(k) ** float(a) for k in range(1, n + 1)]
    z = sum(raw)
    return [p / z for p in raw]


def synthesize_trace(
    *,
    name: str = "synthetic",
    seed: int = 0,
    vocab_size: int = 128,
    requests: int = 32,
    duration_s: float = 4.0,
    arrival: str = "poisson",
    burst_duty: float = 0.25,
    burst_count: int = 0,
    n_prefixes: int = 4,
    zipf_a: float = 1.1,
    prefix_tokens: int = 24,
    tail_tokens: int = 8,
    max_new_tokens: int = 16,
    multi_turn_frac: float = 0.0,
    turns: int = 2,
    think_s: float = 0.4,
    branch_frac: float = 0.0,
    fanout: int = 3,
    completion_fn: Optional[Callable[[List[int], int], List[int]]] = None,
    temperature: float = 0.0,
) -> Trace:
    """Pure-seeded trace synthesis (no clocks, no global RNG): →
    :class:`Trace` of ``requests`` root arrivals plus their derived
    turn/branch events, sorted by arrival.

    * ``arrival="poisson"``: i.i.d. exponential inter-arrival gaps at
      rate ``requests / duration_s`` — the open-loop steady state.
    * ``arrival="bursty"``: roots cluster into ``burst_count`` (default
      ``max(2, requests // 8)``) bursts whose centers spread evenly
      over ``duration_s``; each burst's width is its even share of the
      duration scaled by ``burst_duty`` — an on/off process with duty
      cycle ``burst_duty`` and peak rate ``1/burst_duty`` times the
      mean, the queue-pressure shape autoscalers are sized against.

    Every root's prompt is a Zipf-shared prefix (rank-``zipf_a``
    power-law over ``n_prefixes`` pooled ``prefix_tokens``-token
    prefixes) plus a unique ``tail_tokens``-token tail. A
    ``multi_turn_frac`` fraction of roots become ``turns``-turn chat
    sessions (successor prompt = full prior history + completion +
    fresh user tail, arriving ``think_s`` later with seeded jitter); a
    ``branch_frac`` fraction become agent fan-outs (``fanout`` children
    sharing the root's full history + completion, each with its own
    tail, arriving near-simultaneously ``think_s`` after the root).
    ``completion_fn`` supplies exact completions for those histories
    (see module docstring); None → seeded filler tokens.
    """
    import numpy as np

    if arrival not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process {arrival!r}")
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    rng = np.random.default_rng(int(seed))
    n = int(requests)

    # ---- root arrival process ----
    if arrival == "poisson":
        gaps = rng.exponential(float(duration_s) / n, size=n)
        root_t = np.cumsum(gaps)
    else:
        n_bursts = int(burst_count) or max(2, n // 8)
        span = float(duration_s) / n_bursts
        width = max(1e-3, span * float(burst_duty))
        centers = [(b + 0.5) * span for b in range(n_bursts)]
        root_t = np.sort(np.array([
            centers[i % n_bursts]
            + rng.uniform(-width / 2.0, width / 2.0)
            for i in range(n)
        ]))
    root_t = np.maximum(root_t, 0.0)

    # ---- shared prefix pool (Zipf popularity) ----
    pool = [
        rng.integers(0, vocab_size, size=int(prefix_tokens)).tolist()
        for _ in range(int(n_prefixes))
    ]
    probs = _zipf_probs(int(n_prefixes), float(zipf_a))
    prefix_ids = rng.choice(int(n_prefixes), size=n, p=probs)

    def complete(prompt: List[int], budget: int) -> List[int]:
        if completion_fn is not None:
            return [int(t) for t in completion_fn(prompt, budget)]
        return rng.integers(0, vocab_size, size=int(budget)).tolist()

    def user_tail() -> List[int]:
        return rng.integers(0, vocab_size, size=int(tail_tokens)).tolist()

    # ---- role assignment (seeded permutation, disjoint) ----
    n_branch = min(n, int(round(float(branch_frac) * n)))
    n_turn = min(n - n_branch, int(round(float(multi_turn_frac) * n)))
    order = rng.permutation(n)
    branch_roots = set(int(i) for i in order[:n_branch])
    turn_roots = set(int(i) for i in order[n_branch:n_branch + n_turn])

    events: List[TraceEvent] = []
    for i in range(n):
        t = float(root_t[i])
        prompt = list(pool[int(prefix_ids[i])]) + user_tail()
        if i in turn_roots:
            sid = f"s{i}"
            history = list(prompt)
            arr = t
            for k in range(int(turns)):
                events.append(TraceEvent(
                    arrival_s=arr, prompt=list(history),
                    max_new_tokens=int(max_new_tokens),
                    temperature=float(temperature),
                    session=sid, turn=k, kind="turn",
                ))
                if k + 1 < int(turns):
                    history = (history
                               + complete(history, int(max_new_tokens))
                               + user_tail())
                    arr += float(think_s) * float(rng.uniform(0.75, 1.25))
        elif i in branch_roots:
            sid = f"b{i}"
            events.append(TraceEvent(
                arrival_s=t, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                temperature=float(temperature),
                session=sid, turn=0, kind="single",
            ))
            history = prompt + complete(prompt, int(max_new_tokens))
            base = t + float(think_s)
            for c in range(int(fanout)):
                events.append(TraceEvent(
                    arrival_s=base + float(rng.uniform(0.0, 0.05)),
                    prompt=history + user_tail(),
                    max_new_tokens=int(max_new_tokens),
                    temperature=float(temperature),
                    session=sid, turn=c + 1, kind="branch",
                ))
        else:
            events.append(TraceEvent(
                arrival_s=t, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                temperature=float(temperature),
                kind="single",
            ))
    events.sort(key=lambda ev: (ev.arrival_s, ev.session, ev.turn))
    return Trace(
        name=str(name), seed=int(seed), events=events,
        meta={
            "arrival": arrival, "requests": n,
            "duration_s": float(duration_s),
            "burst_duty": float(burst_duty),
            "n_prefixes": int(n_prefixes), "zipf_a": float(zipf_a),
            "prefix_tokens": int(prefix_tokens),
            "tail_tokens": int(tail_tokens),
            "max_new_tokens": int(max_new_tokens),
            "multi_turn_frac": float(multi_turn_frac),
            "turns": int(turns), "think_s": float(think_s),
            "branch_frac": float(branch_frac), "fanout": int(fanout),
            "vocab_size": int(vocab_size),
            "exact_completions": completion_fn is not None,
        },
    )


# ------------------------------------------------------------ the source

class TraceSource:
    """Stream a :class:`Trace` through the source protocol the engine
    polls (``serve(..., source=)``): ``poll(now_s)`` delivers every
    not-yet-delivered event whose arrival is due at ``now_s`` as a
    ``ServeRequest`` (``arrival_s`` stamped with the trace arrival so
    queue time anchors at ARRIVAL), ``due(now_s)``/``exhausted()`` expose
    backlog, and ``wait(now_s)`` sleeps toward the next arrival through
    the injectable ``sleep``, capped at ``max_wait_s`` so the caller's
    heartbeat cadence survives idle gaps (a fake-clock test injects a
    sleep that ADVANCES its clock and the stream replays
    deterministically).

    ``speed`` compresses trace time into wall time (2.0 = twice as
    fast) without changing the trace.

    ``now_s`` is the CALLER's clock, seconds since ITS run start; the
    source is single-consumer and not thread-safe (the engine polls at
    the wave boundaries of one serve thread)."""

    def __init__(
        self,
        trace: Trace,
        deadline_s: float = 0.0,
        priority: int = 0,
        speed: float = 1.0,
        sleep: Callable[[float], None] = time.sleep,
        max_wait_s: float = 0.05,
    ) -> None:
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        self.trace = trace
        self._events = sorted(trace.events, key=lambda ev: ev.arrival_s)
        self._times = [float(ev.arrival_s) / float(speed)
                       for ev in self._events]
        self._deadline_s = float(deadline_s)
        self._priority = int(priority)
        self._i = 0
        self._sleep = sleep
        self._max_wait = float(max_wait_s)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def delivered(self) -> int:
        return self._i

    def _request(self, idx: int) -> Any:
        from nexus_tpu_torch.runtime.serving import ServeRequest

        ev = self._events[idx]
        return ServeRequest(
            prompt=list(ev.prompt),
            max_new_tokens=ev.max_new_tokens,
            temperature=ev.temperature,
            seed=ev.seed,
            deadline_s=self._deadline_s,
            priority=self._priority,
            arrival_s=self._times[idx],
        )

    def poll(self, now_s: float) -> List[Any]:
        out: List[Any] = []
        while self._i < len(self._events) and self._times[self._i] <= now_s:
            out.append(self._request(self._i))
            self._i += 1
        return out

    def due(self, now_s: float) -> int:
        j = self._i
        while j < len(self._events) and self._times[j] <= now_s:
            j += 1
        return j - self._i

    def exhausted(self) -> bool:
        return self._i >= len(self._events)

    def wait(self, now_s: float) -> None:
        if self.exhausted():
            return
        delta = self._times[self._i] - float(now_s)
        if delta > 0:
            self._sleep(min(delta, self._max_wait))


class ListSource:
    """The degenerate source: a fixed request list delivered on a fixed
    arrival schedule (``[(arrival_s, request), ...]``) — the unit-test
    and smoke harness form where synthesis would obscure the assert.
    Same protocol as :class:`TraceSource`."""

    def __init__(self, timed_requests: Sequence[Any],
                 sleep: Callable[[float], None] = time.sleep,
                 max_wait_s: float = 0.05) -> None:
        import dataclasses

        pairs = sorted(timed_requests, key=lambda p: float(p[0]))
        self._reqs = [
            dataclasses.replace(r, arrival_s=float(t)) for t, r in pairs
        ]
        self._times = [float(t) for t, _ in pairs]
        self._i = 0
        self._sleep = sleep
        self._max_wait = float(max_wait_s)

    def __len__(self) -> int:
        return len(self._reqs)

    @property
    def delivered(self) -> int:
        return self._i

    def poll(self, now_s: float) -> List[Any]:
        out: List[Any] = []
        while self._i < len(self._reqs) and self._times[self._i] <= now_s:
            out.append(self._reqs[self._i])
            self._i += 1
        return out

    def due(self, now_s: float) -> int:
        j = self._i
        while j < len(self._reqs) and self._times[j] <= now_s:
            j += 1
        return j - self._i

    def exhausted(self) -> bool:
        return self._i >= len(self._reqs)

    def wait(self, now_s: float) -> None:
        if self.exhausted():
            return
        delta = self._times[self._i] - float(now_s)
        if delta > 0:
            self._sleep(min(delta, self._max_wait))
