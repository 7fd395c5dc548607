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
root (``TMOG_TORCH_BUILD_DIR`` overrides it), keyed by a hash of the source
and the flags, so a fresh checkout builds everything from its own sources.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

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


def build_dir() -> str:
    return os.environ.get("TMOG_TORCH_BUILD_DIR") or os.path.join(
        _REPO, "build", "torch_kernels")


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


def library_path(name: str) -> str:
    with open(_source(name), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel source that has no current library, one
    ``nvcc`` per source, all started together; returns name -> .so path.
    Raises with the compiler's output if any build fails."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    for n, p in paths.items():
        if n not in todo:
            BUILD_INFO.setdefault(n, {"seconds": 0.0, "log": "cached"})
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
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
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
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load kernel library {path}: {e}") from e
            _LIBS[name] = lib
            # found built on disk, not by nvcc in this process: a cache hit
            cached = BUILD_INFO.get(name, {}).get("log") == "cached"
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
