"""The one percentile estimator of the serving rollups (a copy of
``percentile_nearest_rank`` from ``nexus_tpu/utils/telemetry.py``; the rest
of that module, logging and the metric registry, is not needed here)."""

from __future__ import annotations

from typing import Sequence


def percentile_nearest_rank(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of a (small) population. An EMPTY population
    returns NaN, never 0.0: an all-shed round must not report a perfect
    p95 (callers omit the metric instead)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]
