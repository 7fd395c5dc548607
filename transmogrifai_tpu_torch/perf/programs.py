"""Process-wide content-addressed cache of the training sweep programs, and
the serialized form of a serving plan's bucket executables (counterpart of
``transmogrifai_tpu/perf/programs.py``).

The reference lowers and AOT-compiles each (fold x grid) sweep program once
per key and dispatches through the cached executable.  The port traces and
compiles nothing: a sweep is torch ops and the hand-written kernels, and what
its first call at a key really costs are the kernel builds and library loads
its launches cause (``perf/timers.py::note_compile``).  So:

- ``run_cached(fn, *args, statics=..., label=...)`` — an accounting
  wrapper, not a cache — calls ``fn`` every time and keys the call as the
  reference does — (program source, operand shapes, dtypes
  and devices, statics, key extras, :func:`~.kernels.dispatch.cache_token`)
  — counting the first call at a key as its compile (with the compile
  events it caused) and every later call as a hit;
- ``cache_key_fingerprint`` hashes the program's SOURCE plus the operand
  signature, with no ``id()``: equal across processes;
- ``program_cache_stats()`` has the reference's shape (per-program compiles,
  hits, compile seconds = ``nvcc``'s seconds, backend compiles);
- ``enable_persistent_cache(dir)`` points the kernel build directory — the
  port's only persistent compile cache — at ``dir``;
- ``serialize_compiled`` / ``deserialize_compiled`` turn a serving bucket's
  executable (``serve/plan.py::BucketExecutable``) into JSON bytes and back,
  the deploy artifact's bucket payload.  No pickle: loading an artifact
  never runs code from it.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..obs import flight as obs_flight
from .timers import measure_compiles, phase

#: keys whose first call ran (or is running): later calls are hits
_CALLED: set = set()
_STATS: Dict[tuple, "ProgramStats"] = {}
_LOCK = threading.RLock()
#: source-hash memo keyed by the function OBJECT (strong ref: an id()-keyed
#: memo could serve a dead function's fingerprint to a new one reusing its id)
_SRC_FP: Dict[Any, str] = {}

#: the bucket payload's format tag (``serialize_compiled``)
PAYLOAD_FORMAT = "tmog-torch-bucket-v1"


@dataclass
class ProgramStats:
    """Per-key cache record (one sweep program at one operand signature)."""

    label: str
    fingerprint: str
    shapes: str
    compiles: int = 0
    hits: int = 0
    compile_seconds: float = 0.0
    backend_compiles: int = 0
    fallbacks: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "label": self.label, "fingerprint": self.fingerprint[:16],
            "shapes": self.shapes, "compiles": self.compiles,
            "hits": self.hits,
            "compile_seconds": round(self.compile_seconds, 3),
            "backend_compiles": self.backend_compiles,
            "fallbacks": self.fallbacks,
        }


def _source_fingerprint(fn) -> str:
    """Hash of the program's python source (editing it invalidates every key
    derived from it)."""
    target = inspect.unwrap(getattr(fn, "__wrapped__", fn))
    try:
        hit = _SRC_FP.get(target)
    except TypeError:  # unhashable callable
        hit, target = None, None
    if hit is not None:
        return hit
    try:
        src = inspect.getsource(target if target is not None else fn)
    except (OSError, TypeError):
        src = getattr(fn, "__qualname__", repr(fn))
    fp = hashlib.blake2b(src.encode(), digest_size=8).hexdigest()
    if target is not None:
        with _LOCK:
            _SRC_FP[target] = fp
    return fp


def _arg_sig(a) -> tuple:
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        device = getattr(a, "device", None)
        # a torch tensor's device type; a numpy array lives on the host
        return (tuple(shape), str(dtype).replace("torch.", ""),
                "host" if device is None else getattr(device, "type", str(device)))
    # non-array dynamic operand (python scalar): type only — the VALUE is a
    # runtime input, not part of the program
    return ("py", type(a).__name__)


def _static_item_sig(v) -> Any:
    if callable(v):
        return f"{getattr(v, '__module__', '?')}.{getattr(v, '__qualname__', repr(v))}"
    try:
        hash(v)
    except TypeError:
        return repr(v)
    return v


def _make_key(fn, args, kwargs: Dict[str, Any], statics: Dict[str, Any],
              key_extras: Dict[str, Any]) -> Tuple[tuple, str, str]:
    """(in-memory key, stable fingerprint, shapes summary)."""
    from .kernels.dispatch import cache_token

    src_fp = _source_fingerprint(fn)
    arg_sigs = tuple(_arg_sig(a) for a in args)
    kwarg_sigs = tuple(sorted((k, _arg_sig(v)) for k, v in kwargs.items()))
    static_sig = tuple(sorted(
        (k, _static_item_sig(v)) for k, v in statics.items()))
    extra_sig = tuple(sorted(
        (k, _static_item_sig(v)) for k, v in key_extras.items()))
    name = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"
    # the kernels this process runs key every program: editing a kernel
    # source never counts a call of the old build as a hit
    stable = (name, src_fp, arg_sigs, kwarg_sigs, static_sig, extra_sig,
              cache_token())
    fp = hashlib.blake2b(repr(stable).encode(), digest_size=16).hexdigest()
    # the in-memory key also carries the function OBJECT: two closures from
    # one factory share source but bake in different constants
    try:
        hash(fn)
        key = stable + (fn,)
    except TypeError:  # pragma: no cover — unhashable callable
        key = stable + (id(fn),)
    shapes = ",".join(
        "x".join(map(str, s[0])) if isinstance(s[0], tuple) else "scalar"
        for s in arg_sigs)
    return key, fp, shapes


def cache_key_fingerprint(fn, *args, kwargs: Optional[Dict[str, Any]] = None,
                          statics: Optional[Dict[str, Any]] = None,
                          key_extras: Optional[Dict[str, Any]] = None) -> str:
    """The stable (cross-process) content-addressed key of one program call:
    deterministic in (program source, operand shapes/dtypes/devices,
    statics, key extras, kernel token)."""
    return _make_key(fn, args, kwargs or {}, statics or {},
                     key_extras or {})[1]


def run_cached(fn, *args, kwargs: Optional[Dict[str, Any]] = None,
               statics: Optional[Dict[str, Any]] = None,
               key_extras: Optional[Dict[str, Any]] = None,
               label: Optional[str] = None):
    """Call ``fn(*args, **kwargs, **statics)`` and count it against its key.

    An accounting wrapper, not a cache: ``fn`` runs on every call (the port
    has no compiled program to keep; what a key's first call pays, the
    kernel builds and loads, the build directory keeps).  It gives
    ``program_cache_stats()`` the reference's shape, and its compile
    counts are the ones ``perf/timers.py::measure_compiles`` records.

    ``statics`` are the program's configuration (they join the key by
    value), ``kwargs`` its dynamic keyword operands (by signature), and
    ``key_extras`` ride the key only.  The first call at a key is its
    compile: it runs inside a ``compile.<label>`` phase and a flight
    ``compile_context``, and the compile events its launches cause (kernel
    builds and loads) are added to the key's ``backend_compiles`` and
    ``compile_seconds``; later calls are hits.  A first call that raises
    leaves the key uncounted."""
    kwargs = kwargs or {}
    statics = statics or {}
    key, fp, shapes = _make_key(fn, args, kwargs, statics, key_extras or {})
    with _LOCK:
        stats = _STATS.get(key)
        if stats is None:
            stats = _STATS[key] = ProgramStats(
                label=label or key[0].rsplit(".", 1)[-1],
                fingerprint=fp, shapes=shapes)
        first = key not in _CALLED
        if first:
            _CALLED.add(key)  # a concurrent caller counts a hit
        else:
            stats.hits += 1
    if not first:
        return fn(*args, **kwargs, **statics)
    try:
        with phase(f"compile.{stats.label}"), \
                obs_flight.compile_context(f"perf.run_cached:{stats.label}",
                                           fingerprint=fp), \
                measure_compiles() as delta:
            out = fn(*args, **kwargs, **statics)
            backend, seconds = delta.backend_compiles, delta.compile_seconds
    except BaseException:
        with _LOCK:
            _CALLED.discard(key)
        raise
    with _LOCK:
        stats.compiles += 1
        stats.backend_compiles += backend
        stats.compile_seconds += seconds
    return out


def evict_program_entries(fns) -> int:
    """Drop every cache/stat entry keyed on one of ``fns`` (by identity);
    returns the number removed."""
    targets = {id(f) for f in fns}
    removed = 0
    with _LOCK:
        for key in [k for k in _STATS if id(k[-1]) in targets]:
            _CALLED.discard(key)
            _STATS.pop(key, None)
            removed += 1
    return removed


def program_cache_stats() -> Dict[str, Any]:
    """Aggregate + per-program cache counters."""
    with _LOCK:
        entries = [s.to_dict() for s in _STATS.values()]
    return {
        "programs_compiled": sum(e["compiles"] for e in entries),
        "cache_hits": sum(e["hits"] for e in entries),
        "compile_seconds": round(sum(e["compile_seconds"] for e in entries), 3),
        "fallbacks": sum(e["fallbacks"] for e in entries),
        "programs": entries,
    }


def program_cache_entries() -> Dict[tuple, ProgramStats]:
    """Live per-key stats (tests: compile at most once per (family, bucket))."""
    with _LOCK:
        return dict(_STATS)


def clear_program_cache() -> None:
    with _LOCK:
        _CALLED.clear()
        _STATS.clear()


# ---------------------------------------------------------------------------
# The persistent compile cache: the kernel build directory
# ---------------------------------------------------------------------------

def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Point the kernel build directory (``perf/kernels/dispatch.py``) at
    ``cache_dir``: libraries built there are loaded without ``nvcc`` by any
    later process using it.  Without ``cache_dir``, the directory in use
    (``TMOG_TORCH_BUILD_DIR`` or the repo's ``build/torch_kernels``) stays.
    Returns the directory in use."""
    from .kernels import dispatch

    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        dispatch.set_build_dir(cache_dir)
    return dispatch.build_dir()


# ---------------------------------------------------------------------------
# Bucket executables <-> bytes — the deploy/ artifact's bucket payload
# ---------------------------------------------------------------------------

def serialize_compiled(compiled) -> bytes:
    """A serving bucket's executable (``serve/plan.py::BucketExecutable``)
    -> JSON bytes tagged with :data:`PAYLOAD_FORMAT` and the torch version
    that wrote them.  ``TypeError`` for any other object."""
    import torch

    from ..serve.plan import BucketExecutable

    if not isinstance(compiled, BucketExecutable):
        raise TypeError(f"not a bucket executable: {type(compiled).__name__}")
    return (json.dumps({"format": PAYLOAD_FORMAT, "torch": torch.__version__,
                        **compiled.to_json()}, sort_keys=True) + "\n").encode()


def deserialize_compiled(blob: bytes):
    """bytes (from :func:`serialize_compiled`) -> ``BucketExecutable``.
    ``ValueError`` on bytes that are not JSON of this format (another
    package's executable, a garbled object).  Integrity is the CALLER's job:
    the deploy store verifies each object's sha256 before this call."""
    from ..serve.plan import BucketExecutable

    try:
        d = json.loads(bytes(blob).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"unreadable bucket executable (not {PAYLOAD_FORMAT} "
                         f"JSON): {e}") from e
    if not isinstance(d, dict) or d.get("format") != PAYLOAD_FORMAT:
        fmt = d.get("format") if isinstance(d, dict) else None
        raise ValueError(f"unknown bucket executable format {fmt!r}; this "
                         f"reader takes {PAYLOAD_FORMAT!r}")
    return BucketExecutable.from_json(d)
