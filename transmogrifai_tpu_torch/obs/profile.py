"""``TMOG_PROFILE=<dir>`` — opt-in ``torch.profiler`` capture of the serving
plan's device dispatch and of each model family's sweep launch
(counterpart of ``transmogrifai_tpu/obs/profile.py``).

Setting ``TMOG_PROFILE`` to a directory wraps every such dispatch
(``serve/plan.py::CompiledScoringPlan._dispatch`` and each family's launch
in ``models/tuning.py::sweep_families``) in a ``torch.profiler.profile``
capture of the host and, on a card, the device (CUPTI), exported with
``export_chrome_trace`` into the directory: one Chrome-trace file per
dispatch, named ``<tag>-<pid>-<n>.json``.  The kernels the dispatch
launched appear in it by name (``encode_slots_kernel``, ...).  Unset, the
hook is a single ``os.environ`` read — no profiler, no cost.

Captures do not nest: when a capture is already in flight (an outer
dispatch, another thread), inner dispatches run unprofiled instead of
failing — one capture per dispatch.  A profiler failure logs and the
dispatch goes on unchanged, so scores stay bitwise those of an unprofiled
run.

A capture can come back without some of its GPU events: on an H100 with
torch 2.11, the first events of a capture go missing in a process that has
lived a while, more the older it is (none in its first ~40 s, all of a
served batch's after ~4 minutes), CPU + CUDA and CUDA-only captures alike,
while the host's launch records stay whole.  So each capture counts the
kernels it saw launched against the kernels the device reported, keeps
the counts in :func:`last_capture`, and logs a warning when the device
reported fewer: a trace is never short of kernels without saying so.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading

log = logging.getLogger(__name__)

_LOCK = threading.Lock()
_ACTIVE = False
#: capture sequence numbers (file names)
_SEQ = itertools.count(1)
#: the last finished capture's file and counts (see :func:`last_capture`)
_LAST: dict = {}


def profile_dir() -> str:
    """The configured profile directory ('' when profiling is off)."""
    return os.environ.get("TMOG_PROFILE", "")


def last_capture() -> dict:
    """The last capture this process exported: ``{"tag", "path",
    "launches" (kernel launches the host recorded), "kernels" (kernels the
    device reported), "complete" (no launched kernel missing)}``; empty
    before the first."""
    with _LOCK:
        return dict(_LAST)


def _count(events) -> tuple:
    """(kernel launches on the host, kernels on the device) of a capture."""
    launches = kernels = 0
    for e in events:
        if e.device_type.name == "CUDA":
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += 1
    return launches, kernels


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def maybe_profile(tag: str):
    """Wrap a dispatch in a ``torch.profiler`` capture when ``TMOG_PROFILE``
    is set; otherwise (or when a capture is already active) a no-op.  The
    profiled work is never altered — a profiler failure logs and the
    dispatch proceeds unprofiled."""
    d = profile_dir()
    if not d:
        yield
        return
    global _ACTIVE
    with _LOCK:
        claimed = not _ACTIVE
        if claimed:
            _ACTIVE = True
    prof = None
    if claimed:
        try:
            os.makedirs(d, exist_ok=True)
            from torch.profiler import profile

            prof = profile(activities=_activities())
            prof.start()
        except Exception as e:  # noqa: BLE001 — never break the dispatch
            log.warning("TMOG_PROFILE capture (%s) failed to start: %s",
                        tag, e)
            prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                path = os.path.join(
                    d, f"{tag}-{os.getpid()}-{next(_SEQ):04d}.json")
                prof.export_chrome_trace(path)
                launches, kernels = _count(prof.events())
                with _LOCK:
                    _LAST.clear()
                    _LAST.update(tag=tag, path=path, launches=launches,
                                 kernels=kernels, complete=kernels >= launches)
                if kernels < launches:
                    log.warning("TMOG_PROFILE capture (%s) is missing GPU "
                                "events: %d kernel launches, %d kernels "
                                "reported by the device: %s",
                                tag, launches, kernels, path)
            except Exception as e:  # noqa: BLE001 — never break the dispatch
                log.warning("TMOG_PROFILE capture (%s) failed to stop: %s",
                            tag, e)
        if claimed:
            with _LOCK:
                _ACTIVE = False
