"""Prefix-affinity request routing for the serve fleet (the port's copy of
``nexus_tpu/fleet/router.py``).

Same-prefix requests win from landing on the same engine (the radix
cache, the host tier and Hydragen all feed on it). The router keeps that
locality through load balancing:

* **affinity key**: a prompt's radix chain key at ``affinity_depth`` full
  blocks (``runtime/prefix_cache.py::chain_keys``); a prompt without a
  full block hashes its raw leading tokens;
* **rendezvous choice**: the key's highest-random-weight replica over the
  live set, so a replica leaving moves only its own keys;
* **load-aware spill-over**: power of two choices among the top
  ``spill_candidates`` replicas by weight, leaving the affinity home only
  when it is busier by at least ``spill_threshold`` requests. The load is
  the replica's live ``serve_queue_depth`` gauge (tagged ``engine:<id>``,
  read through the registry's typed ``get_tagged``) unless a load
  function is injected; an upfront routing pass uses its own routed
  counts (``enable_pending_load``).

``route_batch`` routes in priority order (higher first, FIFO within a
tier). Routing is scheduling, never semantics: any assignment gives the
same tokens.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nexus_tpu_torch.runtime.prefix_cache import chain_keys
from nexus_tpu_torch.utils.telemetry import METRIC_SERVE_QUEUE_DEPTH, StatsdClient, get_client

ROUTER_POLICIES = ("affinity", "random")


def affinity_key(prompt: Sequence[int], block_size: int, depth: int = 2) -> bytes:
    """The routing digest of a prompt: its chain key at ``min(full blocks,
    depth)``; a sub-block prompt hashes its raw leading tokens."""
    if depth < 1:
        raise ValueError(f"affinity depth must be >= 1, got {depth}")
    keys = chain_keys(prompt, block_size, limit=depth)
    if keys:
        return keys[-1]
    head = np.asarray(list(prompt)[:block_size], dtype=np.int32)
    return hashlib.sha256(b"sub-block:" + head.tobytes()).digest()


def rendezvous_weight(key: bytes, replica_id: str) -> bytes:
    """Stable pseudo-random weight of (affinity key, replica)."""
    return hashlib.blake2b(key + b"\x00" + replica_id.encode(), digest_size=8).digest()


class PrefixAffinityRouter:
    """Assign requests to replicas, keeping prefix locality.

    ``load_fn(replica_id) -> float`` injects the spill-over load; the
    default reads the replica's ``serve_queue_depth`` gauge from the
    registry (``client``, or the process default). ``policy="random"`` is
    the seeded, cache-blind baseline. Membership and the ledger are
    guarded by ``_lock``."""

    def __init__(self, replica_ids: Sequence[str], block_size: int, affinity_depth: int = 2,
                 spill_candidates: int = 2, spill_threshold: int = 4, policy: str = "affinity",
                 load_fn: Optional[Callable[[str], float]] = None,
                 client: Optional[StatsdClient] = None, seed: int = 0,
                 decision_log: Any = None) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"router policy must be one of {ROUTER_POLICIES}, got {policy!r}")
        if spill_candidates < 1:
            raise ValueError(f"spill_candidates must be >= 1, got {spill_candidates}")
        if spill_threshold < 1:
            raise ValueError(f"spill_threshold must be >= 1, got {spill_threshold}")
        self.block_size = int(block_size)
        self.affinity_depth = int(affinity_depth)
        self.spill_candidates = int(spill_candidates)
        self.spill_threshold = int(spill_threshold)
        self.policy = policy
        self._load_fn = load_fn
        self._client = client
        # when set (obs/fleet_log.py), every route records its evidence
        self.decision_log = decision_log
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()
        self._replicas: List[str] = list(replica_ids)  # guarded-by: _lock
        self.routed: Dict[str, int] = {}  # guarded-by: _lock
        self.spills = 0  # guarded-by: _lock — placements off the affinity home
        self.decisions = 0  # guarded-by: _lock

    def _pending_load(self, rid: str) -> float:
        with self._lock:
            return float(self.routed.get(rid, 0))

    def enable_pending_load(self) -> None:
        """Use the router's own routed counts as the load: an upfront pass
        routes the whole queue before any engine has published a gauge,
        where the registry would read 0 everywhere."""
        self._load_fn = self._pending_load

    # ------------------------------------------------------------ membership
    def replicas(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def set_replicas(self, replica_ids: Sequence[str]) -> None:
        with self._lock:
            self._replicas = list(replica_ids)

    def add_replica(self, replica_id: str) -> None:
        with self._lock:
            if replica_id not in self._replicas:
                self._replicas.append(replica_id)

    def remove_replica(self, replica_id: str) -> None:
        with self._lock:
            self._replicas = [r for r in self._replicas if r != replica_id]

    def unroute(self, replica_id: str) -> None:
        """Take back one routed count of an abandoned assignment (the
        decision count stands: a re-route is a second decision)."""
        with self._lock:
            n = self.routed.get(replica_id, 0)
            if n > 1:
                self.routed[replica_id] = n - 1
            elif n:
                del self.routed[replica_id]

    # --------------------------------------------------------------- routing
    def _load(self, replica_id: str) -> float:
        if self._load_fn is not None:
            return float(self._load_fn(replica_id))
        client = self._client or get_client()
        sample = client.get_tagged(METRIC_SERVE_QUEUE_DEPTH, [f"engine:{replica_id}"])
        return float(sample.value) if sample is not None else 0.0

    def rank(self, key: bytes) -> List[str]:
        """The live replicas by descending affinity weight for ``key``
        (rank[0] is the affinity home)."""
        with self._lock:
            reps = list(self._replicas)
        if not reps:
            raise RuntimeError("router has zero live replicas")
        return sorted(reps, key=lambda r: rendezvous_weight(key, r), reverse=True)

    def route(self, request) -> Tuple[str, bool]:
        """One request → ``(replica_id, spilled)``: the affinity home unless
        a top candidate is less loaded by at least ``spill_threshold``; the
        ``random`` policy draws uniformly over the live replicas."""
        log = self.decision_log
        if self.policy == "random":
            with self._lock:
                reps = list(self._replicas)
                if not reps:
                    raise RuntimeError("router has zero live replicas")
                chosen = reps[int(self._rng.randint(len(reps)))]
                self.decisions += 1
                self.routed[chosen] = self.routed.get(chosen, 0) + 1
            if log is not None:
                log.record("route", journey=str(getattr(request, "journey", "") or ""), key="",
                           policy="random", ranked=[], loads=[], chosen=chosen, spilled=False,
                           spill_threshold=self.spill_threshold)
            return chosen, False
        key = affinity_key(request.prompt, self.block_size, self.affinity_depth)
        candidates = self.rank(key)[: self.spill_candidates]
        chosen = candidates[0]
        spilled = False
        loads: List[float] = []
        if len(candidates) > 1:
            loads = [self._load(r) for r in candidates]
            best = min(range(len(candidates)), key=lambda i: loads[i])
            # affinity wins ties and small imbalances
            if best != 0 and loads[0] - loads[best] >= self.spill_threshold:
                chosen = candidates[best]
                spilled = True
        with self._lock:
            self.decisions += 1
            self.spills += int(spilled)
            self.routed[chosen] = self.routed.get(chosen, 0) + 1
        if log is not None:
            log.record("route", journey=str(getattr(request, "journey", "") or ""),
                       key=key.hex()[:16], policy=self.policy, ranked=list(candidates),
                       loads=[round(float(x), 3) for x in loads], chosen=chosen,
                       spilled=spilled, spill_threshold=self.spill_threshold)
        return chosen, spilled

    def route_batch(self, entries: Sequence) -> List[Tuple[object, str, bool]]:
        """Route entries (anything with a ``.request``) in priority order,
        higher first, FIFO within a tier → ``[(entry, replica_id,
        spilled), ...]`` in routing order."""
        order = sorted(range(len(entries)),
                       key=lambda i: (-int(getattr(entries[i].request, "priority", 0) or 0), i))
        out: List[Tuple[object, str, bool]] = []
        for i in order:
            rid, spilled = self.route(entries[i].request)
            out.append((entries[i], rid, spilled))
        return out

    def ledger(self) -> Dict[str, object]:
        with self._lock:
            return {
                "router_policy": self.policy,
                "router_decisions": self.decisions,
                "router_spills": self.spills,
                "router_routed": dict(self.routed),
            }
