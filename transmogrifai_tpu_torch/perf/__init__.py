"""perf — nestable phase timers and the process-wide compile probe
(``perf.timers``, counterpart of ``transmogrifai_tpu/perf/timers.py``), the
training programs' cache and the bucket executables' serialized form
(``perf.programs``), and the hand-written CUDA kernels with their build
(``perf.kernels``)."""

from .timers import (  # noqa: F401
    CompileStats,
    compile_snapshot,
    current_recorder,
    measure_compiles,
    phase,
    PhaseRecorder,
    record_phases,
)
from .programs import (  # noqa: F401
    cache_key_fingerprint,
    clear_program_cache,
    deserialize_compiled,
    enable_persistent_cache,
    program_cache_stats,
    run_cached,
    serialize_compiled,
)

__all__ = [
    "CompileStats",
    "PhaseRecorder",
    "cache_key_fingerprint",
    "clear_program_cache",
    "compile_snapshot",
    "current_recorder",
    "deserialize_compiled",
    "enable_persistent_cache",
    "measure_compiles",
    "phase",
    "program_cache_stats",
    "record_phases",
    "run_cached",
    "serialize_compiled",
]
