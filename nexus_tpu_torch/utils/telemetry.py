"""The in-process metric registry and the one percentile estimator (the
port's copy of ``nexus_tpu/utils/telemetry.py``: ``GaugeSample``,
``StatsdClient``, ``with_statsd`` / ``get_client``, the serve-plane and
fleet metric names and ``percentile_nearest_rank``; the log handlers and
the control plane's metric names are not needed here).

Gauges land in the registry always, and over DogStatsD (UDP, or a unix
socket) only when ``NEXUS__STATSD_ADDRESS`` (or an explicit address) is
set, as in the JAX package.
"""

from __future__ import annotations

import os
import socket
import threading
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union


class GaugeSample(NamedTuple):
    """One series' last emission: its value, the registry's global
    emission counter at publish time (strictly monotone across all
    series: equal ``seq`` in two reads means nothing was published in
    between) and the emitter's own stamp (the engine's wave count; 0.0
    when none was given). A reader that sees seq and stamp frozen over
    its polls is looking at a wedged emitter."""

    value: float
    seq: int
    stamp: float


# serve-plane live gauges (obs/gauges.py publishes them at every wave
# boundary): wait-queue depth, occupied rows, free pool blocks, host-tier
# bytes, committed tokens, waves, rolling ttft / queue-wait percentiles
METRIC_SERVE_QUEUE_DEPTH = "serve_queue_depth"
METRIC_SERVE_RUNNING_ROWS = "serve_running_rows"
METRIC_SERVE_FREE_BLOCKS = "serve_free_pool_blocks"
METRIC_SERVE_HOST_BYTES = "serve_host_cache_bytes"
METRIC_SERVE_COMMITTED = "serve_committed_tokens"
METRIC_SERVE_WAVES = "serve_waves_total"
METRIC_SERVE_TTFT_P50 = "serve_ttft_p50_s"
METRIC_SERVE_TTFT_P95 = "serve_ttft_p95_s"
METRIC_SERVE_QUEUE_P50 = "serve_queue_p50_s"
METRIC_SERVE_QUEUE_P95 = "serve_queue_p95_s"
# fleet-level rollups of the per-replica gauges (obs/federation.py)
METRIC_FLEET_QUEUE_DEPTH = "fleet_queue_depth_total"
METRIC_FLEET_FREE_BLOCKS = "fleet_free_pool_blocks_total"
METRIC_FLEET_COMMITTED = "fleet_committed_tokens_total"
METRIC_FLEET_REPLICAS = "fleet_replicas_alive"
METRIC_FLEET_TTFT_P50 = "fleet_ttft_p50_s"
METRIC_FLEET_TTFT_P95 = "fleet_ttft_p95_s"
METRIC_FLEET_LATENCY_P50 = "fleet_latency_p50_s"
METRIC_FLEET_LATENCY_P95 = "fleet_latency_p95_s"
METRIC_FLEET_SLO_ATTAINMENT = "fleet_slo_attainment"


def percentile_nearest_rank(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of a (small) population. An EMPTY population
    returns NaN, never 0.0: an all-shed round must not report a perfect
    p95 (callers omit the metric instead)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class StatsdClient:
    """Tagged gauges in an in-process registry, mirrored fire-and-forget
    over DogStatsD when an address is configured.

    Every mutable structure is guarded by ``_lock``: the engine's wave loop
    writes while readers render. ``snapshot`` is the consistent read (one
    lock hold), ``get_tagged`` / ``tagged_series`` the typed reads the
    fleet router uses; the history is a bounded ring."""

    #: history ring capacity (telemetry must never grow memory)
    HISTORY_CAP = 10000

    def __init__(self, app_name: str = "nexus-tpu", address: Optional[str] = None):
        self.app_name = app_name
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        # UDP (host, port) or a unix-socket path
        self._addr: Optional[Union[Tuple[str, int], str]] = None
        self.gauges: Dict[str, float] = {}  # guarded-by: _lock
        # last value per (name, tags) series: the exposition surface
        self.tagged: Dict[Tuple[str, Tuple[str, ...]], float] = {}  # guarded-by: _lock
        self._tagged_meta: Dict[Tuple[str, Tuple[str, ...]], GaugeSample] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock — global emission counter
        self.history: deque = deque(maxlen=self.HISTORY_CAP)  # guarded-by: _lock
        address = address or os.environ.get("NEXUS__STATSD_ADDRESS", "")
        if address.startswith("unix://"):
            self._addr = address[len("unix://"):]
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        elif address:
            host, _, port = address.partition(":")
            self._addr = (host, int(port or 8125))
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def gauge(self, name: str, value: float, tags: Optional[List[str]] = None,
              rate: float = 1.0, stamp: Optional[float] = None) -> None:
        """``stamp``: the emitter's own publish clock (the engine's wave
        count), kept per series for the staleness signal; never sent."""
        full = f"{self.app_name}.{name}"
        tag_tuple = tuple(tags or [])
        with self._lock:
            self._seq += 1
            self.gauges[full] = value
            self.tagged[(full, tag_tuple)] = value
            self._tagged_meta[(full, tag_tuple)] = GaugeSample(
                float(value), self._seq, float(stamp) if stamp is not None else 0.0)
            self.history.append((full, value, tag_tuple))
        if self._sock and self._addr:
            tag_str = f"|#{','.join(tags)}" if tags else ""
            try:
                self._sock.sendto(f"{full}:{value}|g|@{rate}{tag_str}".encode(), self._addr)
            except OSError:
                pass

    def get_tagged(self, name: str, tags: Optional[Sequence[str]] = None
                   ) -> Optional[GaugeSample]:
        """The last emission of ONE series (bare ``name``, exactly ``tags``),
        or None when it never emitted."""
        with self._lock:
            return self._tagged_meta.get((f"{self.app_name}.{name}", tuple(tags or [])))

    def tagged_series(self, tag: str) -> Dict[str, GaugeSample]:
        """Every series carrying ``tag``, as ``{bare name: GaugeSample}``;
        where one name was emitted under several tag sets holding ``tag``,
        the latest emission wins."""
        prefix = f"{self.app_name}."
        out: Dict[str, GaugeSample] = {}
        with self._lock:
            for (full, tag_tuple), sample in self._tagged_meta.items():
                if tag not in tag_tuple:
                    continue
                bare = full[len(prefix):] if full.startswith(prefix) else full
                prior = out.get(bare)
                if prior is None or sample.seq > prior.seq:
                    out[bare] = sample
        return out

    def snapshot(self) -> Dict[str, object]:
        """One consistent copy of the registry (a single lock hold):
        ``gauges`` (untagged last values), ``series`` (per (name, tags))
        and ``history_len``."""
        with self._lock:
            return {"gauges": dict(self.gauges), "series": dict(self.tagged),
                    "history_len": len(self.history)}


_default_client: Optional[StatsdClient] = None
_client_lock = threading.Lock()


def with_statsd(app_name: str, address: Optional[str] = None) -> StatsdClient:
    """Install a fresh process-default client."""
    global _default_client
    with _client_lock:
        _default_client = StatsdClient(app_name, address)
        return _default_client


def get_client() -> StatsdClient:
    """The process-default client (made on first use)."""
    global _default_client
    with _client_lock:
        if _default_client is None:
            _default_client = StatsdClient()
        return _default_client
