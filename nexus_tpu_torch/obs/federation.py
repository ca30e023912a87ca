"""Fleet-level gauges: the per-replica serve gauges rolled up (the port's
copy of ``nexus_tpu/obs/federation.py``).

:class:`FleetGauges` publishes the ``fleet_*`` family into the same
registry: sums over the replicas' ``engine:<id>`` gauges (queue depth,
free pool blocks, committed tokens; a replica that never published is
skipped, not counted as zero), merged-sample ttft and latency percentiles
(one window fed with every replica's finished requests, ranked once) and,
given an SLO, the share of finished requests served ok within it.
:func:`fleet_rollup` is the read-side sum for tooling. Registry writes
only; no clock reads.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from nexus_tpu_torch.obs.gauges import RollingPercentiles
from nexus_tpu_torch.utils.telemetry import (
    METRIC_FLEET_COMMITTED,
    METRIC_FLEET_FREE_BLOCKS,
    METRIC_FLEET_LATENCY_P50,
    METRIC_FLEET_LATENCY_P95,
    METRIC_FLEET_QUEUE_DEPTH,
    METRIC_FLEET_REPLICAS,
    METRIC_FLEET_SLO_ATTAINMENT,
    METRIC_FLEET_TTFT_P50,
    METRIC_FLEET_TTFT_P95,
    METRIC_SERVE_COMMITTED,
    METRIC_SERVE_FREE_BLOCKS,
    METRIC_SERVE_QUEUE_DEPTH,
    StatsdClient,
    get_client,
)

#: the per-replica gauges the sums federate (name → fleet name)
_SUM_ROLLUPS = (
    (METRIC_SERVE_QUEUE_DEPTH, METRIC_FLEET_QUEUE_DEPTH),
    (METRIC_SERVE_FREE_BLOCKS, METRIC_FLEET_FREE_BLOCKS),
    (METRIC_SERVE_COMMITTED, METRIC_FLEET_COMMITTED),
)


def _sum_rollups(client: StatsdClient, replica_ids: Sequence[str]) -> dict:
    """``{fleet name: total}`` for every family at least one replica
    published (the one loop both the publisher and the reader use)."""
    out = {}
    for per_replica, fleet_name in _SUM_ROLLUPS:
        total, seen = 0.0, 0
        for rid in replica_ids:
            sample = client.get_tagged(per_replica, [f"engine:{rid}"])
            if sample is not None:
                total += float(sample.value)
                seen += 1
        if seen:
            out[fleet_name] = total
    return out


class FleetGauges:
    """Publish fleet-level rollups: :meth:`observe_result` per stitched
    finished request, :meth:`publish` once per poll. ``tags`` tell fleets
    in one process apart."""

    def __init__(self, client: Optional[StatsdClient] = None,
                 tags: Optional[List[str]] = None, slo_s: float = 0.0,
                 ttft_window: int = 512, latency_window: int = 512) -> None:
        self._client = client  # None: the process default, resolved lazily
        self.tags = list(tags or [])
        self.slo_s = float(slo_s)
        self.ttft = RollingPercentiles(ttft_window)
        self.latency = RollingPercentiles(latency_window)
        self.finished = 0
        self.attained = 0
        self.publishes = 0

    @property
    def client(self) -> StatsdClient:
        if self._client is None:
            self._client = get_client()
        return self._client

    def observe_result(self, ttft_s: float, latency_s: float, ok: bool) -> None:
        """One stitched finished request; ``ok``: it completed (ok or
        failed over), else it counts as finished but never attained."""
        self.finished += 1
        if ok:
            self.ttft.add(float(ttft_s))
            self.latency.add(float(latency_s))
            if self.slo_s > 0 and float(latency_s) <= self.slo_s:
                self.attained += 1

    def publish(self, replica_ids: Sequence[str], stamp: float) -> None:
        """One poll's publication, stamped with the publisher's ``stamp``."""
        c = self.client
        tags = self.tags or None
        s = float(stamp)
        for fleet_name, total in _sum_rollups(c, replica_ids).items():
            c.gauge(fleet_name, total, tags=tags, stamp=s)
        c.gauge(METRIC_FLEET_REPLICAS, len(replica_ids), tags=tags, stamp=s)
        for (name50, name95), win in (
            ((METRIC_FLEET_TTFT_P50, METRIC_FLEET_TTFT_P95), self.ttft),
            ((METRIC_FLEET_LATENCY_P50, METRIC_FLEET_LATENCY_P95), self.latency),
        ):
            p50, p95 = win.percentiles((0.50, 0.95))
            for name, v in ((name50, p50), (name95, p95)):
                if not math.isnan(v):
                    c.gauge(name, round(v, 6), tags=tags, stamp=s)
        if self.slo_s > 0 and self.finished:
            c.gauge(METRIC_FLEET_SLO_ATTAINMENT, round(self.attained / self.finished, 4),
                    tags=tags, stamp=s)
        self.publishes += 1


def fleet_rollup(replica_ids: Sequence[str], client: Optional[StatsdClient] = None) -> dict:
    """Read-side rollup: ``{fleet name: total}`` for every family a replica
    published, plus ``fleet_replicas_alive``."""
    c = client or get_client()
    out = {METRIC_FLEET_REPLICAS: len(replica_ids)}
    out.update(_sum_rollups(c, replica_ids))
    return out
