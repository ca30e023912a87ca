"""Wave-boundary live gauges of the serving engine (the port's copy of
``nexus_tpu/obs/gauges.py``).

:class:`LiveGauges` publishes the engine's vitals at every wave boundary
(queue depth, running rows, free pool blocks, host-tier bytes, committed
tokens, waves, rolling ttft and queue-wait percentiles) into the
in-process registry (``utils/telemetry.py``), where the fleet router reads
a replica's load and ``obs/exposition.py`` renders Prometheus text. Every
value is a host integer the engine already holds: no publish reads a
tensor.

:class:`RollingPercentiles` is the bounded window behind the percentile
gauges, scored with the shared nearest-rank estimator.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional

from nexus_tpu_torch.utils.telemetry import (
    METRIC_SERVE_COMMITTED,
    METRIC_SERVE_FREE_BLOCKS,
    METRIC_SERVE_HOST_BYTES,
    METRIC_SERVE_QUEUE_DEPTH,
    METRIC_SERVE_QUEUE_P50,
    METRIC_SERVE_QUEUE_P95,
    METRIC_SERVE_RUNNING_ROWS,
    METRIC_SERVE_TTFT_P50,
    METRIC_SERVE_TTFT_P95,
    METRIC_SERVE_WAVES,
    StatsdClient,
    get_client,
    percentile_nearest_rank,
)


class RollingPercentiles:
    """Nearest-rank percentiles over a sliding window of the last
    ``window`` observations. An empty window scores NaN: the gauge is
    omitted rather than published as 0.0."""

    def __init__(self, window: int = 256) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._xs: deque = deque(maxlen=int(window))
        self.count = 0  # observations ever added

    def add(self, x: float) -> None:
        self._xs.append(float(x))
        self.count += 1

    def __len__(self) -> int:
        return len(self._xs)

    def percentile(self, q: float) -> float:
        return percentile_nearest_rank(list(self._xs), q)

    def percentiles(self, qs) -> List[float]:
        """Several ranks off one sorted copy of the window (NaN each for an
        empty window)."""
        if not self._xs:
            return [float("nan")] * len(qs)
        s = sorted(self._xs)
        n = len(s)
        return [s[min(n - 1, int(round(q * (n - 1))))] for q in qs]


class LiveGauges:
    """Publish one wave boundary's vitals into the registry. ``tags``
    (``["engine:r0"]``) tell replicas in one process apart."""

    def __init__(self, client: Optional[StatsdClient] = None,
                 tags: Optional[List[str]] = None,
                 ttft_window: int = 256, queue_window: int = 256) -> None:
        self._client = client  # None: the process default, resolved lazily
        self.tags = list(tags or [])
        self.ttft = RollingPercentiles(ttft_window)
        self.queue_wait = RollingPercentiles(queue_window)
        self.publishes = 0

    @property
    def client(self) -> StatsdClient:
        if self._client is None:
            self._client = get_client()
        return self._client

    def observe_finish(self, ttft_s: float, queue_s: float) -> None:
        """Feed one served request into the rolling windows (the same
        population as the engine's end-of-run rollups)."""
        self.ttft.add(ttft_s)
        self.queue_wait.add(queue_s)

    def publish(self, queue_depth: int, running_rows: int, free_pool_blocks: int,
                host_cache_bytes: int, committed_tokens: int, waves: int) -> None:
        c = self.client
        tags = self.tags or None
        # every gauge of the boundary carries the wave count as its stamp:
        # a wedged engine's stamp stops advancing
        w = float(waves)
        c.gauge(METRIC_SERVE_QUEUE_DEPTH, queue_depth, tags=tags, stamp=w)
        c.gauge(METRIC_SERVE_RUNNING_ROWS, running_rows, tags=tags, stamp=w)
        c.gauge(METRIC_SERVE_FREE_BLOCKS, free_pool_blocks, tags=tags, stamp=w)
        c.gauge(METRIC_SERVE_HOST_BYTES, host_cache_bytes, tags=tags, stamp=w)
        c.gauge(METRIC_SERVE_COMMITTED, committed_tokens, tags=tags, stamp=w)
        c.gauge(METRIC_SERVE_WAVES, waves, tags=tags, stamp=w)
        for (name50, name95), win in (
            ((METRIC_SERVE_TTFT_P50, METRIC_SERVE_TTFT_P95), self.ttft),
            ((METRIC_SERVE_QUEUE_P50, METRIC_SERVE_QUEUE_P95), self.queue_wait),
        ):
            p50, p95 = win.percentiles((0.50, 0.95))
            for name, v in ((name50, p50), (name95, p95)):
                if not math.isnan(v):  # empty window: omitted, never 0.0
                    c.gauge(name, round(v, 6), tags=tags, stamp=w)
        self.publishes += 1
