"""Serve-plane observability of the port (counterpart of
``nexus_tpu/obs/``, with the same exported names):

* :mod:`~nexus_tpu_torch.obs.trace`: :class:`ServeTracer`, a span timeline
  per request (enqueued → admitted → prefill chunks → decode waves →
  terminal) with cache attribution;
* :mod:`~nexus_tpu_torch.obs.gauges`: :class:`LiveGauges`, wave-boundary
  vitals into the in-process registry;
* :mod:`~nexus_tpu_torch.obs.recorder`: :class:`FlightRecorder`, a bounded
  ring of wave events that dumps a snapshot on a sanitizer trip, a
  shed or deadline storm, or a drain;
* :mod:`~nexus_tpu_torch.obs.exposition`: Prometheus text and a JSON
  snapshot of the registry;
* :mod:`~nexus_tpu_torch.obs.profiling`: ``torch.profiler.record_function``
  scopes around the engine's dispatch sites (``NEXUS_OBS_JAX_TRACE=1``);
* the fleet's: :class:`JourneyBook` (cross-replica journeys, goodput under
  an SLO), :class:`FleetDecisionLog` (the router's decisions with their
  evidence) and :class:`FleetGauges` (fleet-level rollups).

All of it is host-side bookkeeping on plain Python values: no hook reads
a tensor, and none reads a clock of its own (the engine stamps events with
its injectable clock).
"""

from nexus_tpu_torch.obs.exposition import (  # noqa: F401
    registry_snapshot,
    render_prometheus,
)
from nexus_tpu_torch.obs.federation import (  # noqa: F401
    FleetGauges,
    fleet_rollup,
)
from nexus_tpu_torch.obs.fleet_log import (  # noqa: F401
    FLEET_EVENT_FIELDS,
    FLEET_LOG_SCHEMA_VERSION,
    FleetDecisionLog,
    validate_fleet_log,
)
from nexus_tpu_torch.obs.gauges import LiveGauges, RollingPercentiles  # noqa: F401
from nexus_tpu_torch.obs.journey import (  # noqa: F401
    JOURNEY_ENTRY_FIELDS,
    JOURNEY_LEG_FIELDS,
    JOURNEY_SCHEMA_VERSION,
    JourneyBook,
    goodput_under_slo,
    journey_attribution,
    slo_verdicts,
    validate_journey,
)
from nexus_tpu_torch.obs.recorder import (  # noqa: F401
    FlightRecorder,
    validate_flight_dump,
    write_dump,
)
from nexus_tpu_torch.obs.trace import (  # noqa: F401
    SPAN_FIELDS,
    TRACE_SCHEMA_VERSION,
    ServeTracer,
    validate_trace,
)
