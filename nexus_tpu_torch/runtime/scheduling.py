"""Admission-ordering policies for the serving engine (a copy of
``nexus_tpu/runtime/scheduling.py``, which is pure Python; the port keeps
its own so that it imports nothing of the JAX package).

The wait-queue used to be strictly FIFO inside ``ServingEngine.serve``
itself. This module extracts the ORDERING decision into a small policy
object — the first slice of the ROADMAP scheduler/executor split: the
engine stays the executor (dispatch, leases, pool), and *which* queued
request a freed row takes next becomes a pluggable policy instead of
further surgery on runtime/serving.py.

Two policies ship:

  * ``FifoAdmission`` — arrival order, the earlier behavior and the
    A/B baseline.
  * ``CacheAwareAdmission`` — order admissible requests to maximize
    reuse of prefixes currently RESIDENT in the radix prefix cache
    (longest-resident-match-first, SGLang RadixAttention's cache-aware
    scheduling): a request whose whole preamble is parked right now
    admits before a cold one, converting parked blocks into hits before
    pool pressure evicts them and keeping same-subtree requests
    together so their shared runs stay hot. Starvation is bounded by an
    AGING rule: a request passed over ``aging_waves`` times is promoted
    ahead of every non-aged request (aged requests among themselves are
    FIFO), so the worst case is a bounded delay, never a livelock.

The engine's exactness contract is untouched by construction: ordering
changes WHEN a request is scheduled, never what is computed — proven
token-for-token in tests/test_serving.py across policies.

Pool-full semantics carry over from FIFO: when the policy's chosen head
cannot reserve its blocks, the wave stops and that request waits for
refunds (it is never overtaken *within* the policy order), which
combined with aging preserves the no-starvation guarantee.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

ADMISSION_POLICIES = ("fifo", "cache-aware")


class AdmissionPolicy:
    """Order the wait queue for one admission wave.

    ``order`` receives the pending request indices in ARRIVAL order, the
    per-request passed-over counts (how many admission waves have
    overtaken each request so far), and a ``resident_match`` callback
    returning the prompt tokens currently matchable against cache
    content — either a plain int (resident tokens, the original
    signature) or a ``(resident, spilled)`` pair once the host spill
    tier is attached: a SPILLED hit still needs a restore
    upload, so it ranks below a resident hit of any depth but above a
    cold miss — tiers compare lexicographically. It returns the indices
    in the order admission should try them. Policies must be
    deterministic and pure (no clocks — aging is counted in waves, so
    scheduling replays exactly under the injectable-clock test
    discipline).

    Cost note: the engine calls ``order`` once per admission wave over
    the whole pending queue (cache-aware additionally re-matches each
    pending request against the radix tree — an O(prefix) walk on
    host-cached chain keys). That re-ranking is what lets deferred
    groups and freshly-parked completion chains re-rank honestly, but
    it prices each wave O(queue): serve configs should bound the
    backlog with ``maxQueueDepth`` (the example config does), and an
    incremental ranker is follow-up work under the ROADMAP
    scheduler/executor split."""

    name = "custom"  # subclasses name themselves for the metrics ledger

    def __init__(self) -> None:
        # observability surface: a policy MAY refresh this
        # dict inside ``order`` with cheap facts about the wave it just
        # ranked (``pending`` size, how many aged requests jumped the
        # queue, ...); the engine copies it into the flight recorder's
        # admission event, so chaos postmortems show WHY the queue was
        # ordered the way it was. Never read by scheduling logic —
        # purely a telemetry export. INSTANCE-owned (assigned here, not
        # a class default): two engines' policies in one process must
        # never report each other's wave meta, even if a subclass
        # mutates the dict in place.
        self.last_wave_meta: Dict[str, int] = {}

    def order(
        self,
        pending: Sequence[int],
        passed_over: Dict[int, int],
        resident_match: Callable[[int], int],
    ) -> List[int]:
        raise NotImplementedError


class FifoAdmission(AdmissionPolicy):
    """Strict arrival order — the earlier engine behavior."""

    name = "fifo"

    def order(self, pending, passed_over, resident_match):
        self.last_wave_meta = {"pending": len(pending), "aged": 0}
        return list(pending)


class CacheAwareAdmission(AdmissionPolicy):
    """Longest-resident-match-first with a bounded aging guarantee.

    Aged requests (passed over >= ``aging_waves`` admission waves) go
    first, in arrival order; everyone else is sorted by descending
    resident match length — with the host spill tier attached, by the
    ``(resident, spilled)`` pair lexicographically, so a spilled hit
    (which costs a restore upload) outranks a miss but never a resident
    hit — with arrival order as the tie-break. A cache-cold queue
    degrades to exact FIFO, and a request can be overtaken at most
    ``aging_waves`` times before it outranks every fresher arrival."""

    name = "cache-aware"

    def __init__(self, aging_waves: int = 8) -> None:
        super().__init__()
        if aging_waves < 1:
            raise ValueError(
                f"aging_waves must be >= 1, got {aging_waves}"
            )
        self.aging_waves = int(aging_waves)

    @staticmethod
    def _tiers(match) -> Tuple[int, int]:
        """Normalize the ranking signal: a plain int is resident-only
        (the original signature and every custom callback written
        against it); a pair is (resident, spilled)."""
        if isinstance(match, tuple):
            return match
        return (match, 0)

    def order(self, pending, passed_over, resident_match):
        pending = list(pending)
        pos = {idx: i for i, idx in enumerate(pending)}
        aged = [
            i for i in pending
            if passed_over.get(i, 0) >= self.aging_waves
        ]
        fresh = [
            i for i in pending
            if passed_over.get(i, 0) < self.aging_waves
        ]

        def key(i):
            resident, spilled = self._tiers(resident_match(i))
            return (-resident, -spilled, pos[i])

        fresh.sort(key=key)
        self.last_wave_meta = {"pending": len(pending), "aged": len(aged)}
        return aged + fresh


def make_admission_policy(
    spec: Union[str, AdmissionPolicy], aging_waves: int = 8
) -> AdmissionPolicy:
    """Resolve a policy name (``ServeSpec.admissionPolicy``) or pass an
    already-built policy through (the pluggable-interface path)."""
    if isinstance(spec, AdmissionPolicy):
        return spec
    if spec == "fifo":
        return FifoAdmission()
    if spec == "cache-aware":
        return CacheAwareAdmission(aging_waves=aging_waves)
    raise ValueError(
        f"admission_policy must be one of {ADMISSION_POLICIES} (or an "
        f"AdmissionPolicy instance), got {spec!r}"
    )
