"""Per-stage metrics collection and profiling hooks (OpSparkListener
equivalent; counterpart of ``transmogrifai_tpu/utils/listener.py``).

Reference: OpSparkListener (utils/.../spark/OpSparkListener.scala:62-196)
subscribes to Spark's event bus and collects per-stage task metrics (run
time, records), app start/end, with JSON serde; attached by OpApp and
controlled by ``logStageMetrics``/``collectStageMetrics``.

Here the workflow's fit and transform loops emit stage events to the
registered listeners; metrics capture wall time, row/column counts, and the
card's memory in use and its peak (``torch.cuda.memory_allocated`` /
``max_memory_allocated`` on the current device; ``None`` on the CPU).

The port's training flush runs a whole table through one plan: its device
prefix is one encode launch for every prefix stage, never a stage at a
time, and prefix work never moves to the host for a listener.  So a flush
reports one ``transform`` record per stage it ran, each with the stage's
exact rows and columns; a host-remainder stage carries its own seconds, a
prefix stage the wall time of the whole prefix it ran in
(``workflow/plan.py``).

``profile_trace`` wraps a block in a ``torch.profiler`` capture exported
as a Chrome trace (host and, on a card, device activity).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("transmogrifai_tpu_torch.metrics")


@dataclass
class StageMetrics:
    """One fit or transform execution of one stage (reference StageMetrics)."""

    stage_uid: str
    stage_class: str
    operation_name: str
    phase: str                      # "fit" | "transform"
    wall_ms: float
    n_rows: int
    n_cols_in: int
    n_cols_out: int
    started_at: float               # unix seconds
    device_bytes_in_use: Optional[int] = None
    device_peak_bytes: Optional[int] = None

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class AppMetrics:
    """Whole-run metrics (reference AppMetrics): app bounds + per-stage list."""

    app_name: str = "transmogrifai_tpu"
    run_type: Optional[str] = None
    custom_tag: Optional[str] = None
    started_at: float = 0.0
    ended_at: float = 0.0
    stage_metrics: List[StageMetrics] = field(default_factory=list)

    @property
    def app_duration_ms(self) -> float:
        return max(0.0, (self.ended_at - self.started_at) * 1000.0)

    def to_dict(self) -> dict:
        return {
            "appName": self.app_name,
            "runType": self.run_type,
            "customTagName": self.custom_tag,
            "appStartTime": self.started_at,
            "appEndTime": self.ended_at,
            "appDurationMs": self.app_duration_ms,
            "stageMetrics": [m.to_dict() for m in self.stage_metrics],
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _device_memory() -> tuple[Optional[int], Optional[int]]:
    """(bytes in use, peak bytes) of the current CUDA device; (None, None)
    when there is no card."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None, None
        dev = torch.cuda.current_device()
        return (int(torch.cuda.memory_allocated(dev)),
                int(torch.cuda.max_memory_allocated(dev)))
    except Exception:
        return None, None


class OpMetricsListener:
    """Collects StageMetrics from workflow runs; optionally logs each stage.

    ``log_stage_metrics`` mirrors the reference's log-as-you-go mode;
    ``collect_stage_metrics`` keeps them on the listener for export
    (OpSparkListener.scala metrics accumulation).
    """

    def __init__(self, log_stage_metrics: bool = False,
                 collect_stage_metrics: bool = True,
                 track_device_memory: bool = False,
                 app_name: str = "transmogrifai_tpu",
                 custom_tag: Optional[str] = None):
        self.log_stage_metrics = log_stage_metrics
        self.collect_stage_metrics = collect_stage_metrics
        self.track_device_memory = track_device_memory
        self.metrics = AppMetrics(app_name=app_name, custom_tag=custom_tag)

    # -- events ------------------------------------------------------------
    def on_app_start(self, run_type: Optional[str] = None) -> None:
        self.metrics.run_type = run_type
        self.metrics.started_at = time.time()

    def on_app_end(self) -> None:
        self.metrics.ended_at = time.time()

    def on_stage_complete(self, m: StageMetrics) -> None:
        if self.collect_stage_metrics:
            self.metrics.stage_metrics.append(m)
        if self.log_stage_metrics:
            log.info("stage %s (%s) %s: %.1fms rows=%d cols=%d->%d",
                     m.operation_name, m.stage_class, m.phase, m.wall_ms,
                     m.n_rows, m.n_cols_in, m.n_cols_out)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.metrics.to_json())


# Listener registry — a ContextVar so concurrent runs (threads / nested contexts)
# each see only their own listeners and don't cross-contaminate metrics.
_LISTENERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "transmogrifai_tpu_torch_listeners", default=())


def add_listener(listener: OpMetricsListener) -> OpMetricsListener:
    _LISTENERS.set(_LISTENERS.get() + (listener,))
    return listener


def remove_listener(listener: OpMetricsListener) -> None:
    current = _LISTENERS.get()
    if listener in current:
        _LISTENERS.set(tuple(x for x in current if x is not listener))


def active_listeners() -> List[OpMetricsListener]:
    return list(_LISTENERS.get())


@contextlib.contextmanager
def stage_timer(stage, phase: str, dataset):
    """Times one stage execution and notifies listeners; zero-cost when none active."""
    if not _LISTENERS.get():
        yield lambda out_ds: None
        return
    t0 = time.time()
    result: Dict[str, Any] = {}

    def finish(out_ds) -> None:
        result["out_cols"] = len(out_ds.names) if out_ds is not None else 0

    yield finish
    notify_stage(stage, phase, (time.time() - t0) * 1000.0, dataset.n_rows,
                 len(dataset.names), result.get("out_cols", 0), t0)


def notify_stage(stage, phase: str, wall_ms: float, n_rows: int,
                 n_cols_in: int, n_cols_out: int, started_at: float) -> None:
    """Hand one stage execution timed by its caller to the active
    listeners (the training flush reports each stage it ran this way);
    a no-op when none is active."""
    listeners = _LISTENERS.get()
    if not listeners:
        return
    track_mem = any(l.track_device_memory for l in listeners)
    in_use, peak = _device_memory() if track_mem else (None, None)
    m = StageMetrics(
        stage_uid=stage.uid,
        stage_class=type(stage).__name__,
        operation_name=stage.operation_name,
        phase=phase,
        wall_ms=wall_ms,
        n_rows=n_rows,
        n_cols_in=n_cols_in,
        n_cols_out=n_cols_out,
        started_at=started_at,
        device_bytes_in_use=in_use,
        device_peak_bytes=peak,
    )
    for listener in listeners:
        listener.on_stage_complete(m)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Wrap a block in a ``torch.profiler`` capture when a log dir is given,
    exported as ``<log_dir>/trace-<pid>.json`` (a Chrome trace: host
    activity, and on a card the kernels and copies)."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
