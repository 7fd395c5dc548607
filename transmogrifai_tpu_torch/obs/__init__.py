"""obs — the serving metrics registry, pipeline overlap stats and the SLO
burn-rate monitor (counterparts of ``transmogrifai_tpu/obs/metrics.py``,
``overlap.py`` and ``slo.py``).  The reference's tracer, request tracks,
flight recorder and profiler hooks are not ported."""

from .metrics import (  # noqa: F401
    CANONICAL_METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    canonical_help,
)
from .overlap import OverlapStats  # noqa: F401
from .slo import SloBudget, SloMonitor  # noqa: F401
