"""obs — the serving server's metrics registry and pipeline overlap stats
(counterparts of ``transmogrifai_tpu/obs/metrics.py`` and ``overlap.py``).
The reference's tracer, request tracks, flight recorder and profiler hooks
are not ported."""

from .metrics import (  # noqa: F401
    CANONICAL_METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    canonical_help,
)
from .overlap import OverlapStats  # noqa: F401
