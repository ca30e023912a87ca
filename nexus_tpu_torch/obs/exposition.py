"""The in-process registry rendered for scrapers (the port's copy of
``nexus_tpu/obs/exposition.py``): :func:`render_prometheus` (Prometheus
text exposition v0.0.4, every series a gauge, DogStatsD ``key:value`` tags
as labels) and :func:`registry_snapshot` (the same view as a JSON-safe
dict). Both read one locked copy of the registry.
"""

from __future__ import annotations

import re
from typing import Optional

from nexus_tpu_torch.utils.telemetry import StatsdClient, get_client

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    """DogStatsD dotted name → Prometheus metric name."""
    name = _NAME_SANITIZE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_labels(tags) -> str:
    """``key:value`` tags → ``{key="value",...}`` (a tag without a colon
    becomes ``tag="<raw>"``)."""
    if not tags:
        return ""
    parts = []
    for t in tags:
        k, sep, v = str(t).partition(":")
        if not sep:
            k, v = "tag", str(t)
        k = _LABEL_SANITIZE.sub("_", k) or "tag"
        v = str(v).replace("\\", r"\\").replace('"', r"\"")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def render_prometheus(client: Optional[StatsdClient] = None) -> str:
    """The registry as Prometheus text, families and series sorted (two
    renders of one registry state are byte-identical)."""
    snap = (client or get_client()).snapshot()
    by_family: dict = {}
    for (name, tags), value in snap["series"].items():
        by_family.setdefault(_prom_name(name), []).append((_prom_labels(tags), value))
    lines = []
    for fam in sorted(by_family):
        lines.append(f"# TYPE {fam} gauge")
        for labels, value in sorted(by_family[fam]):
            lines.append(f"{fam}{labels} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


def registry_snapshot(client: Optional[StatsdClient] = None) -> dict:
    """JSON-safe snapshot: ``gauges`` (untagged last values), ``series``
    (one entry per (name, tags)) and ``history_len``."""
    snap = (client or get_client()).snapshot()
    return {
        "gauges": {k: v for k, v in sorted(snap["gauges"].items())},
        "series": [{"name": name, "tags": list(tags), "value": value}
                   for (name, tags), value in sorted(snap["series"].items())],
        "history_len": snap["history_len"],
    }
