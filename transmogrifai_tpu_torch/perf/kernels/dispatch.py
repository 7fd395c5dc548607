"""Device resolution and the build of the port's hand-written CUDA kernels.

Counterpart of ``transmogrifai_tpu/perf/kernels/dispatch.py``.  The reference
chose at trace time between Pallas kernels and XLA formulas; the port has no
such switch.  A tensor on the CPU takes a kernel's plain PyTorch version (the
tests run there), a tensor on a CUDA device always takes the kernel, and a
kernel that does not build or launch raises :class:`KernelError` — nothing
falls back.

Kernels are CUDA C++ for ``sm_90a`` under ``csrc/``, compiled with ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, into ``build/torch_kernels/`` at the repo
root (``TMOG_TORCH_BUILD_DIR`` overrides it, and
``perf/programs.py::enable_persistent_cache`` over both), keyed by a hash of
the source and the flags, so a fresh checkout builds everything from its own
sources.  Beside each library ``nvcc`` built, a build record
(``<library>.so.json``) names the source digest and the CUDA toolkit that built
it; a library without one is built again.  A library packed into a deploy
artifact (``deploy/store.py``) is installed by :func:`install_library`, only
when its source digest is the live one, into a directory of its own keyed by
its sha256 (``artifacts/<sha256>/`` in the build directory) and adopted by
this process alone: :func:`load` then loads it and never runs ``nvcc``, and
no other process takes it for a build of its checkout's sources.

:func:`cache_token` names the kernels a process runs (a digest of each
source and the flags, and the serve-donation choice): it joins every serving
plan's fingerprint, every training program's cache key and every deploy
artifact's provenance.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Set

import torch

from ..timers import note_compile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel library name -> loaded ctypes handle
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: (library, function) pairs whose ctypes signature is set
_BOUND: set = set()
#: library name -> {"seconds": build seconds (0 when cached), "log": ptxas/nvcc output}
BUILD_INFO: Dict[str, Dict[str, object]] = {}
#: library name -> an artifact's library this process installed (install_library)
_INSTALLED: Dict[str, str] = {}


class KernelError(RuntimeError):
    """A kernel that did not build, load or launch, or a fault the device
    reported while one ran.  Callers that leave a failed model out of a
    sweep let this propagate: it is never a property of the model."""


def is_kernel_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a kernel's or the device's failure (as opposed to
    a model's): a :class:`KernelError`, or the error torch raises when the
    device reports a fault (an illegal address, a launch failure)."""
    return isinstance(exc, (KernelError, torch.AcceleratorError))


#: the device entry points called without one run on, inside use_device()
_DEFAULT_DEVICE = None


@contextlib.contextmanager
def use_device(device):
    """Within the block, an entry point called without ``device`` runs on
    ``device`` (as if each call had named it): how a caller runs code that
    names no device, an example app for one, on the CPU."""
    global _DEFAULT_DEVICE
    prev, _DEFAULT_DEVICE = _DEFAULT_DEVICE, torch.device(device)
    try:
        yield
    finally:
        _DEFAULT_DEVICE = prev


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another (by ``device``, or around the call by
    :func:`use_device`).  No card and no explicit device is an error, never
    a silent move to the CPU."""
    if device is None:
        device = _DEFAULT_DEVICE
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


#: the build directory ``enable_persistent_cache(dir)`` set, over the env
_BUILD_DIR: Optional[str] = None


def build_dir() -> str:
    return _BUILD_DIR or os.environ.get("TMOG_TORCH_BUILD_DIR") or os.path.join(
        _REPO, "build", "torch_kernels")


def set_build_dir(path: Optional[str]) -> None:
    """Point the kernel build directory at ``path`` (None: back to
    ``TMOG_TORCH_BUILD_DIR`` or the repo's ``build/torch_kernels``)."""
    global _BUILD_DIR
    _BUILD_DIR = None if path is None else str(path)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine that has the card")
    return found


def _source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


#: (source path, size, mtime, flags) -> sha256 of the source and the flags
_DIGESTS: Dict[tuple, str] = {}


def source_digest(name: str) -> str:
    """sha256 of kernel source ``name`` and :data:`NVCC_FLAGS`: what a
    library built from it is keyed by."""
    path = _source(name)
    st = os.stat(path)
    key = (path, st.st_size, st.st_mtime_ns, NVCC_FLAGS)
    digest = _DIGESTS.get(key)
    if digest is None:
        with open(path, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        _DIGESTS[key] = digest  # opcheck: allow(TM306) memo of a pure function of its key: racing writers store one value
    return digest


def kernel_sources() -> List[str]:
    """The kernel libraries of this checkout: one per ``csrc/*.cu``."""
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(name: str) -> str:
    """Where ``nvcc`` builds library ``name`` from this checkout's source."""
    return os.path.join(build_dir(), f"{name}-{source_digest(name)[:16]}.so")


def library_file(name: str) -> str:
    """The file :func:`load` loads for library ``name``: the artifact's
    library this process installed, else the build directory's."""
    return _INSTALLED.get(name) or library_path(name)


def _write_json_atomic(path: str, obj: Dict[str, object]) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, sort_keys=True)
    os.replace(tmp, path)


def library_record(name: str) -> Dict[str, object]:
    """The build record of :func:`library_file` (``sourceDigest``,
    ``cudaToolkit``: the toolkit that built it, ``origin``: ``nvcc`` or the
    artifact it came from), or ``{}`` when it has none."""
    try:
        with open(library_file(name) + ".json") as fh:
            record = json.load(fh)
    except (OSError, ValueError):
        return {}
    return record if isinstance(record, dict) else {}


_FORCED_DONATION: Optional[bool] = None


def serve_donation() -> bool:
    """Whether serving plans are marked donated (``TMOG_SERVE_DONATE``;
    default off).  The choice rides :func:`cache_token` into every plan
    fingerprint and artifact key, so a donated artifact never hydrates a
    non-donated plan; the port's device programs do not change with it
    (``serve/plan.py::CompiledScoringPlan.donated``)."""
    if _FORCED_DONATION is not None:
        return _FORCED_DONATION
    raw = os.environ.get("TMOG_SERVE_DONATE", "").strip().lower()
    return raw in ("1", "on", "true", "yes", "donate")


@contextlib.contextmanager
def force_serve_donation(flag: bool):
    """Pin the serve-donation choice for a ``with`` block (tests).  Not
    re-entrant across threads."""
    global _FORCED_DONATION
    prev, _FORCED_DONATION = _FORCED_DONATION, bool(flag)
    try:
        yield
    finally:
        _FORCED_DONATION = prev


#: (build dir, flags, donation, tuning token) -> token: the sources are read
#: once a process
_TOKENS: Dict[tuple, str] = {}


def cache_token() -> str:
    """The kernel component of every plan fingerprint, program cache key and
    deploy artifact: ``kernels:cuda:`` and the first 12 hex digits of each
    kernel source's :func:`source_digest`, plus ``:serve-donate`` when
    donation is on, plus ``:tune=<digest>`` when the autotuner adopted a
    non-default launch plan (``perf/autotune.py::tuning_token``, which
    loads the winner store here, before any launch the key covers).
    Editing a kernel or the flags gives a new token; a process reads the
    sources once (per build directory, flags, donation choice and tuning
    token), so a source edited under a running process changes the token
    of the next process only."""
    from .. import autotune

    key = (build_dir(), NVCC_FLAGS, serve_donation(), autotune.tuning_token())
    token = _TOKENS.get(key)
    if token is None:
        token = "kernels:cuda:" + ",".join(f"{n}={source_digest(n)[:12]}"
                                           for n in kernel_sources())
        if key[2]:
            token += ":serve-donate"
        if key[3]:
            token += f":{key[3]}"
        _TOKENS[key] = token  # opcheck: allow(TM306) memo of a pure function of its key: racing writers store one value
    return token


@functools.lru_cache(maxsize=1)
def toolkit_version() -> Optional[str]:
    """The CUDA toolkit's ``major.minor`` as ``nvcc --version`` reports it
    (the toolkit this process builds kernels with), or None without
    ``nvcc``."""
    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (KernelError, OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"release (\d+\.\d+)", out)
    return m.group(1) if m else None


def install_library(name: str, blob: bytes, digest: str,
                    toolkit: Optional[str] = None) -> Optional[str]:
    """Install a prebuilt library of kernel source ``name`` for this
    process, only when ``digest`` (the source digest it was built from) is
    the live :func:`source_digest`: the blob goes to
    ``artifacts/<sha256>/`` in the build directory (temp file, then an
    atomic rename), with a build record naming ``toolkit`` and the
    artifact, and :func:`load` takes it from there for ``name`` in this
    process only.  Returns the path, or None for a library of other sources
    (nothing written: a clean miss).  The caller verified ``blob``'s
    integrity."""
    if digest != source_digest(name):
        return None
    sha = hashlib.sha256(blob).hexdigest()
    path = os.path.join(build_dir(), "artifacts", sha, f"{name}-{digest[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _write_json_atomic(path + ".json", {"sourceDigest": digest, "cudaToolkit": toolkit,
                                            "origin": f"artifact:{sha}"})
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, path)
    with _LOCK:
        _INSTALLED[name] = path
    return path


def uninstall_library(name: str) -> None:
    """Undo :func:`install_library` for ``name``: remove the installed file
    and its record, and let :func:`load` build from source again."""
    with _LOCK:
        path = _INSTALLED.pop(name, None)
    if path is not None:
        for p in (path, path + ".json"):
            if os.path.exists(p):
                os.remove(p)


#: the library names :func:`load` was asked for, per active recorder
_USED = threading.local()


@contextlib.contextmanager
def libraries_used():
    """Collect the kernel libraries the calling thread's launches load
    inside the block (a set of names)."""
    names: Set[str] = set()
    prev = getattr(_USED, "names", None)
    _USED.names = names
    try:
        yield names
    finally:
        _USED.names = prev
        if prev is not None:
            prev.update(names)


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel source that has no current library (a
    library, and its build record), one ``nvcc`` per source, all started
    together; returns name -> .so path.  Raises with the compiler's output
    if any build fails."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items()
            if not (os.path.exists(p) and os.path.exists(p + ".json"))}
    for n, p in paths.items():
        if n not in todo:
            BUILD_INFO.setdefault(n, {"seconds": 0.0, "log": "cached"})  # opcheck: allow(TM306) load() calls build under _LOCK; a direct build is a one-thread build step
    if not todo:
        return paths
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, _source(n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}  # opcheck: allow(TM306) load() calls build under _LOCK; a direct build is a one-thread build step
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        _write_json_atomic(todo[n] + ".json", {
            "sourceDigest": source_digest(n), "cudaToolkit": toolkit_version(),
            "origin": "nvcc"})
        os.replace(tmp, todo[n])  # atomic: concurrent builders agree on the file
        note_compile("nvcc_build", BUILD_INFO[n]["seconds"], cache_hit=False,
                     library=n)
    if failed:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load kernel library ``name``; ``signatures`` maps
    each exported C function to its ctypes argument types (every function
    returns the ``cudaError_t`` of its launch as an int).  Several modules
    may bind functions of one library, each with its own signatures."""
    used = getattr(_USED, "names", None)
    if used is not None:
        used.add(name)
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _INSTALLED.get(name)
            if path is None:
                path = build([name])[name]
                # found built on disk, not by nvcc in this process: a cache hit
                cached = BUILD_INFO.get(name, {}).get("log") == "cached"
            else:
                BUILD_INFO[name] = {"seconds": 0.0, "log": f"installed {path}"}
                cached = True
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load kernel library {path}: {e}") from e
            _LIBS[name] = lib
            note_compile("library_load", cache_hit=True if cached else None,
                         library=name)
        for fn, argtypes in signatures.items():
            if (name, fn) in _BOUND:
                continue
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _BOUND.add((name, fn))
        return lib


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what}: CUDA kernel launch failed (cudaError_t {err})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
