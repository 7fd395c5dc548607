"""perf — nestable phase timers and the process-wide compile probe
(``perf.timers``, counterpart of ``transmogrifai_tpu/perf/timers.py``), and
the hand-written CUDA kernels with their build (``perf.kernels``)."""

from .timers import (  # noqa: F401
    CompileStats,
    compile_snapshot,
    current_recorder,
    measure_compiles,
    phase,
    PhaseRecorder,
    record_phases,
)
