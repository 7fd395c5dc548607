"""Persistent kernel autotuner over the Hopper kernels' launch plans.

Counterpart of ``transmogrifai_tpu/perf/autotune.py``.  The reference's
whole value proposition is automatic selection over a candidate space: its
ModelSelector sweeps estimators and grids, scores each candidate and keeps
the winner.  This module applies the same "sweep, verify, cache" discipline
to the launch plans of the port's hand-written kernels
(``perf/kernels/{histogram,splitscan,routing,encode}.py``): on first
contact with a ``(device_kind, kernel family, shape class)`` triple it
times a bounded grid of launch plans, verifies every candidate against the
kernel's plain PyTorch version on the same device BEFORE it is eligible,
and persists the winner in a content-addressed, schema-versioned JSON
store.

The store's contracts are the reference's:

- **At most one sweep per triple per store.**  :func:`ensure_tuned`
  memoizes in-process under a per-key lock (two racing first contacts
  produce ONE sweep) and a warm store answers every later process from
  disk: zero sweeps.
- **Verified before eligible.**  A candidate whose output differs from the
  plain version (bitwise for the integer fixtures of every family; the
  float histogram within ``histogram.f32_tolerance``), or that fails to
  launch, can never win.  Entries without ``verified: true`` are ignored.
- **Winners ride ``dispatch.cache_token()``.**  Adopting a non-default
  winner folds ``tune=<digest>`` into the token, so tuned plan
  fingerprints, program keys and deploy artifacts never alias untuned ones.
- **Corrupt or stale entries read as defaults**, never as errors;
  :func:`clear` removes entries.

Two things differ from the reference:

- A **shape class** carries the device type (``cuda`` or ``cpu``) where the
  reference carries the kernel mode, so a CPU winner never reaches the
  card; :func:`device_kind` is the sanitized ``torch.cuda.get_device_name``
  of a card, or ``cpu``.
- The **candidates are launch plans**.  Candidate 0 is always what the
  module's ``plan()`` picks by its rules, so an untuned process launches
  exactly as before, and every candidate passes the launcher's own fit
  check (shared memory, threads, tile divisibility).  On the card: ``hist``
  varies the int8 path's warps a CTA and slice-row floor, the float path's
  staged rows ``R`` and waves of slices; ``split`` the staging, the feature
  tile ``FT`` and the sharers ``S``; ``route`` the tile rows or the direct
  path and the threads a CTA; ``encode`` the grid cap.  On the CPU each
  family varies what its plain version can: the row chunk of ``hist`` and
  ``route``, the default alone for ``encode`` and ``split``.

Sweeping is explicit or armed: ``ensure_tuned(..., sweep_on_miss=True)``,
``cli tune run``, and ``TMOG_AUTOTUNE=1`` (arms first-contact sweeps in
:func:`ensure_tuned`).  The launchers only ever consume cached winners
(:func:`launch_params`): a launch never pays sweep time.  A winner that does
not fit a launch's actual shape is logged and the default plan runs.
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import math
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .kernels import dispatch as _dispatch

log = logging.getLogger(__name__)

#: store schema — bump on any incompatible entry-layout change; mismatched
#: entries read as absent (defaults), never as errors
SCHEMA_VERSION = 1

#: timing repetitions per candidate (min of reps; the first launch excluded)
_SWEEP_REPS = 3
#: device seconds a rep aims for (back-to-back launches), the most launches
#: a rep takes, and the cycles of the sleep kernel that holds the card's
#: stream while the host enqueues them (~5 ms on an H100)
_REP_SECONDS = 5e-4
_REP_LAUNCHES = 20
_HOLD_CYCLES = 10_000_000

_GUARD_LOCK = threading.Lock()
#: (device_kind, family, shape_class) -> TuneDecision, guarded by _GUARD_LOCK
_MEMO: Dict[Tuple[str, str, str], "TuneDecision"] = {}
#: per-key sweep locks so one first-contact sweep wins; guarded by _GUARD_LOCK
_KEY_LOCKS: Dict[Tuple[str, str, str], threading.Lock] = {}
#: store dirs already bulk-loaded into _MEMO; guarded by _GUARD_LOCK
_LOADED_DIRS: set = set()
#: process-lifetime sweep counter (tests pin "at most one sweep per triple")
_SWEEPS = 0
#: bumped whenever adoption changes: the launchers' resolved-winner cache
#: (:func:`launch_params`) is valid for one generation
_GENERATION = 0
#: (family, device, dims) -> (generation, params or None)
_LAUNCH_CACHE: Dict[tuple, Tuple[int, Optional[Dict[str, Any]]]] = {}
#: (family, class, params) of misfit winners already logged
_MISFITS: set = set()
#: family -> launches that took an adopted non-default winner (:func:`applied`)
_APPLIED: Dict[str, int] = {}
#: the ``tune=<digest>`` cache-token component over every adopted
#: non-default winner ("" untuned: untuned runs keep the fingerprints they
#: had before the autotuner), and whether there is any such winner
_TOKEN = ""
_TUNED = False


@dataclass(frozen=True)
class TuneDecision:
    """The resolved tuning for one (device_kind, family, shape_class)."""

    family: str
    shape_class: str
    device_kind: str
    params: Dict[str, Any]
    source: str                      # "default" | "cached" | "swept"
    verified: bool = False
    candidates: int = 0
    best_seconds: Optional[float] = None
    default_seconds: Optional[float] = None
    eligible: int = 0

    def is_default(self) -> bool:
        return self.params == family_defaults(self.family, self.shape_class)


# ---------------------------------------------------------------------------
# Store: content-addressed JSON entries, atomic writes, fail-open reads
# ---------------------------------------------------------------------------

def store_dir() -> str:
    """The winner store: ``TMOG_AUTOTUNE_DIR``, else ``autotune/`` beside the
    kernel build directory (``build/autotune`` at the repo root by
    default)."""
    return (os.environ.get("TMOG_AUTOTUNE_DIR")
            or os.path.join(os.path.dirname(_dispatch.build_dir()), "autotune"))


@functools.lru_cache(maxsize=16)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _sanitize(raw: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in str(raw).strip().lower()) or "cpu"


def _device(device=None) -> torch.device:
    """The device a sweep or a class names: ``device``, else the one
    ``dispatch.use_device`` set, else the card when there is one, else the
    CPU.  Only names identity: nothing runs there by this choice."""
    if device is None:
        device = _dispatch._DEFAULT_DEVICE
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_kind(device=None) -> str:
    """Sanitized identity of ``device`` for store keys: the card's name
    (``torch.cuda.get_device_name``), or ``cpu``."""
    dev = _device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _sanitize(_card_name(index))


def _local_kinds() -> set:
    """The device kinds this process can launch on: the CPU and each card."""
    kinds = {"cpu"}
    if torch.cuda.is_available():
        kinds.update(device_kind(torch.device("cuda", i))
                     for i in range(torch.cuda.device_count()))
    return kinds


def _entry_path(device: str, family: str, shape_class: str,
                store: Optional[str] = None) -> str:
    key = f"tmog-autotune|{SCHEMA_VERSION}|{device}|{family}|{shape_class}"
    digest = hashlib.blake2b(key.encode(), digest_size=10).hexdigest()
    return os.path.join(store or store_dir(), f"{family}-{digest}.json")


def _write_atomic(path: str, payload: Dict[str, Any]) -> None:
    """Torn-write-free entry write: tmp file + fsync + atomic replace (a
    concurrent reader sees the old entry or the new one, never a prefix)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    data = json.dumps(payload, sort_keys=True, indent=1).encode()
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _read_entry(path: str) -> Optional[Dict[str, Any]]:
    """One store entry, fail-open: corrupt JSON, schema drift, or an
    unverified sweep all read as None (defaults), never an exception."""
    try:
        with open(path, "rb") as fh:
            entry = json.loads(fh.read().decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    if not isinstance(entry, dict):
        return None
    if entry.get("schema") != SCHEMA_VERSION:
        log.warning("autotune: schema %r != %d in %s — ignoring entry",
                    entry.get("schema"), SCHEMA_VERSION, path)
        return None
    if not entry.get("verified") or not isinstance(entry.get("params"), dict):
        return None
    return entry


def winners(store: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every readable winner entry in the store (cli ``tune show``)."""
    root = store or store_dir()
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        entry = _read_entry(os.path.join(root, name))
        if entry is not None:
            out.append(entry)
    return out


def clear(store: Optional[str] = None) -> int:
    """Remove every entry (cli ``tune clear``); resets in-process adoption
    so the next lookup re-reads the (now empty) store."""
    root = store or store_dir()
    removed = 0
    try:
        names = os.listdir(root)
    except OSError:
        names = []
    for name in names:
        if name.endswith(".json"):
            try:
                os.unlink(os.path.join(root, name))
                removed += 1
            except OSError:  # pragma: no cover — concurrent clear
                pass
    reset()
    return removed


def reset() -> None:
    """Drop in-process adoption state (tests; ``clear``).  The next
    ``tuning_token()`` / lookup reloads the store from disk."""
    global _SWEEPS
    with _GUARD_LOCK:
        _MEMO.clear()
        _KEY_LOCKS.clear()
        _LOADED_DIRS.clear()
        _MISFITS.clear()
        _SWEEPS = 0
        _push_token_locked()


def sweep_count() -> int:
    """Sweeps performed by this process (tests pin once-per-triple)."""
    with _GUARD_LOCK:
        return _SWEEPS


# ---------------------------------------------------------------------------
# Shape classes and family registry
# ---------------------------------------------------------------------------

def _log2_bucket(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(int(n), 2)))))


def shape_class(family: str, device=None, **dims: int) -> str:
    """Canonical shape-class string: the device type (``cuda`` or ``cpu``)
    and every structural dim, row counts log2-bucketed so nearby batch
    sizes share a winner."""
    parts = [_device(device).type]
    for name in sorted(dims):
        v = int(dims[name])
        if name in ("rows", "n"):
            parts.append(f"{name}2^{_log2_bucket(v)}")
        else:
            parts.append(f"{name}{v}")
    return f"{family}:" + ":".join(parts)


_DIM = re.compile(r"^([a-z_]+?)(\d+)(?:\^(\d+))?$")


def _parse_class(shape_cls: str) -> Tuple[str, Dict[str, int]]:
    """(device type, dims) of a shape class; a log2-bucketed row count
    reads as its bucket's top, ``2**k``."""
    parts = shape_cls.split(":")
    dev = parts[1] if len(parts) > 1 else "cpu"
    dims: Dict[str, int] = {}
    for part in parts[2:]:
        m = _DIM.match(part)
        if m is None:
            continue
        name, v, exp = m.groups()
        dims[name] = int(v) ** int(exp) if exp is not None else int(v)
    return dev, dims


#: default sweep fixture dims per family: small enough to sweep on a CPU
#: host, large enough that the plans' choices change the timing.  ``hist``
#: is the int8 path (``int_exact`` 1), ``encode`` one one-hot slot
DEFAULT_DIMS: Dict[str, Dict[str, int]] = {
    "hist": {"rows": 4096, "features": 16, "bins": 8, "lanes": 2,
             "nodes": 8, "classes": 1, "int_exact": 1},
    "split": {"lanes": 4, "nodes": 8, "classes": 1, "features": 16,
              "bins": 8},
    "encode": {"rows": 4096, "slots": 1, "width": 16},
    "route": {"rows": 4096, "features": 16, "lanes": 4},
}

FAMILIES = tuple(sorted(DEFAULT_DIMS))


def _kernels():
    from .kernels import encode as KE
    from .kernels import histogram as KH
    from .kernels import routing as KR
    from .kernels import splitscan as KS

    return KH, KS, KR, KE


def _hist_args(dims: Dict[str, int]) -> tuple:
    """histogram.plan's positional arguments for hist dims."""
    return (dims["lanes"], dims["rows"], dims["features"], dims["nodes"],
            2 * dims["classes"], dims["bins"], bool(dims.get("int_exact", 1)))


def card_plan(family: str, dims: Dict[str, int],
              params: Optional[Dict[str, Any]] = None):
    """The launcher's plan of one family at ``dims`` under ``params`` (None:
    its rules).  Raises ValueError where ``params`` do not fit: the
    launcher's own fit check."""
    KH, KS, KR, KE = _kernels()
    if family == "hist":
        return KH.plan(*_hist_args(dims), params=params)
    if family == "split":
        return KS.plan(dims["lanes"], dims["nodes"], dims["classes"],
                       dims["features"], dims["bins"], params=params)
    if family == "route":
        return KR.plan(dims["lanes"], dims["rows"], dims["features"],
                       params=params)
    if family == "encode":
        return KE.grid_cap_of(params)
    raise ValueError(f"unknown autotune family {family!r}")


def _plan_params(family: str, plan, dims: Dict[str, int]) -> Dict[str, Any]:
    """The tunable knobs of a card plan."""
    if family == "hist":
        if dims.get("int_exact", 1):
            return {"warps": plan["threads"] // 32,
                    "min_slice_rows": plan["min_slice_rows"]}
        return {"R": plan["R"], "waves": plan["waves"]}
    if family == "split":
        return {"staged": plan.staged, "FT": plan.feats, "S": plan.groups}
    if family == "route":
        return {"path": plan.path, "rows": plan.rows, "threads": plan.threads}
    return {"grid_cap": int(plan)}


def family_defaults(family: str, shape_cls: str) -> Dict[str, Any]:
    """The untuned parameter set for a family at the class: what the
    launcher's rules pick (candidate 0), or on the CPU the plain version's
    defaults."""
    if family not in DEFAULT_DIMS:
        raise ValueError(f"unknown autotune family {family!r}")
    dev, dims = _parse_class(shape_cls)
    KH, KS, KR, KE = _kernels()
    if dev != "cuda":
        if family == "hist":
            return {"chunk": KH.PLAIN_CHUNK}
        if family == "route":
            return {"chunk": KR.PLAIN_CHUNK}
        if family == "encode":
            return {"grid_cap": KE.DEFAULT_GRID_CAP}
        return {}
    dims = dict(DEFAULT_DIMS[family], **dims)
    return _plan_params(family, card_plan(family, dims), dims)


def _grid(family: str, dev: str, dims: Dict[str, int]) -> List[Dict[str, Any]]:
    """The raw candidate grid of one family (before the fit check)."""
    KH, KS, KR, KE = _kernels()
    if dev != "cuda":
        if family == "hist":
            return [{"chunk": c} for c in (512, 1024, 2048, 4096, 8192)]
        if family == "route":
            return [{"chunk": c} for c in (1024, 2048, 4096, 8192)]
        return []
    if family == "hist":
        if dims.get("int_exact", 1):
            return [{"warps": w, "min_slice_rows": m}
                    for w in (32, 16, 8) for m in (4096, 8192, 16384)]
        return [{"R": r, "waves": v} for r in KH.F32_STAGE_ROWS for v in (1, 2, 4)]
    if family == "split":
        first = min(KS.SCAN_MAX_FEATS, -(-max(dims["features"], 1) // 32) * 32)
        tiles = [first] + [ft for ft in (128, 64, 32) if ft < first]
        return ([{"staged": True, "FT": ft, "S": s} for ft in tiles for s in (1, 2, 4)]
                + [{"staged": False, "FT": first, "S": s} for s in (1, 2)])
    if family == "route":
        return ([{"path": "tile", "rows": r, "threads": t}
                 for r in KR.TILE_ROWS for t in (256, 128)]
                + [{"path": "direct", "rows": t, "threads": t} for t in (256, 128)])
    if family == "encode":
        return [{"grid_cap": g} for g in (264, 528, 1056, 2112, 4224)]
    raise ValueError(f"unknown autotune family {family!r}")


def family_candidates(family: str, shape_cls: str) -> List[Dict[str, Any]]:
    """The bounded candidate grid for one family at the class.  The default
    parameter set is always candidate 0, so a sweep can only improve on
    (never silently regress) the untuned plan; on the card every candidate
    passes the launcher's fit check at the class's dims."""
    dev, dims = _parse_class(shape_cls)
    dims = dict(DEFAULT_DIMS[family], **dims)
    seen: List[Dict[str, Any]] = [family_defaults(family, shape_cls)]
    for cand in _grid(family, dev, dims):
        if cand in seen:
            continue
        if dev == "cuda":
            try:
                card_plan(family, dims, cand)
            except ValueError:
                continue
        seen.append(cand)
    return seen


# ---------------------------------------------------------------------------
# The sweep's fixtures: a runner per candidate, the plain version, the check
# ---------------------------------------------------------------------------

def _encode_specs(KE, slots: int, width: int) -> list:
    """A table of ``slots`` slots over ``width`` columns: up to a fifth
    bucketize slots (4 splits, both flags: 5 columns each) where the columns
    allow, the rest one-hot slots sharing the remaining columns."""
    n_b = min(slots // 5, max(0, (width - slots) // 4)) if slots > 1 else 0
    n_o = slots - n_b
    rest = width - 5 * n_b
    if n_o < 1 or rest < n_o:
        raise ValueError(f"cannot lay {slots} slots over {width} columns")
    specs = [KE.onehot_slot(rest // n_o + (k < rest % n_o)) for k in range(n_o)]
    specs += [KE.bucketize_slot([-1.0, 0.0, 0.5, 1.0], True, True)
              for _ in range(n_b)]
    return specs


def _family_bench(family: str, dims: Dict[str, int], dev: torch.device
                  ) -> Tuple[Callable[[Dict[str, Any]], Callable], Callable,
                             Callable[[Any, Any], bool], Dict[str, int]]:
    """(make, reference, verify, work) for one family on ``dev``:
    ``make(params)`` returns a zero-arg callable launching the candidate,
    ``reference()`` the plain version's output on the same inputs,
    ``verify(out, ref)`` whether a candidate's output is eligible, and
    ``work`` the bytes the function must move and the operations it does
    on these inputs (each input read once, each output written once)."""
    KH, KS, KR, KE = _kernels()
    g = torch.Generator(device=dev).manual_seed(17)
    card = dev.type == "cuda"

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    if family == "hist":
        L, n, d, nn, two_k, n_bins, int_exact = _hist_args(dims)
        local = ints(-1, nn, (L, n))
        binned = ints(0, n_bins + 1, (n, d))
        if int_exact:
            gh = ints(-3, 4, (L, two_k, n)).to(torch.int8)
        else:
            gh = torch.randn((L, two_k, n), generator=g, device=dev)

        def make(params):
            if card:
                p = KH.plan(L, n, d, nn, two_k, n_bins, int_exact, params=params)
                return lambda: KH.launch(local, gh, binned, nn, n_bins, int_exact, p)
            return lambda: KH.hist_level_torch(local, gh, binned, nn, n_bins,
                                               int_exact=int_exact,
                                               chunk=int(params["chunk"]))

        def reference():
            return KH.hist_level_torch(local, gh, binned, nn, n_bins,
                                       int_exact=int_exact)

        tol = None if int_exact else KH.f32_tolerance(
            KH.hist_level_torch(local, gh.abs(), binned, nn, n_bins))

        def verify(out, ref):
            if out.shape != ref.shape or out.dtype != ref.dtype:
                return False
            if tol is None:
                return torch.equal(out, ref)
            return bool(((out - ref).abs() <= tol).all())  # opcheck: allow(TM301) a tuning sweep checks each candidate's output once

        live = (local >= 0) & (local < nn) & (gh != 0).any(dim=1)
        work = {"bytes": KH.bound_bytes(L, n, d, nn, two_k, n_bins, int_exact),
                "ops": int(live.sum()) * two_k * d}  # opcheck: allow(TM301) a tuning sweep counts the work of its inputs once
        return make, reference, verify, work

    if family == "split":
        L, nn, K = dims["lanes"], dims["nodes"], dims["classes"]
        d, n_bins = dims["features"], dims["bins"]
        shape = (L, nn, K, d, n_bins + 1)
        hg = ints(-20, 20, shape).to(torch.float32)
        hh = ints(0, 30, shape).to(torch.float32)
        G = hg[:, :, :, 0, :].sum(-1).contiguous()
        H = hh[:, :, :, 0, :].sum(-1).contiguous()
        mask = torch.ones((L, d), device=dev)
        args = (hg, hh, G, H, mask, n_bins, 0.0, 0.0, 0.0, 1.0)

        def make(params):
            if card:
                p = KS.plan(L, nn, K, d, n_bins, params=params)
                return lambda: KS.launch(*args, p)
            return lambda: KS.split_scan_torch(*args)

        def reference():
            return KS.split_scan_torch(*args)

        def verify(out, ref):
            return all(a.shape == b.shape and torch.equal(a, b)
                       for a, b in zip(out, ref))

        work = {"bytes": KS.bound_bytes(L, nn, K, d, n_bins),
                "ops": KS.bound_ops(L, nn, K, d, n_bins)}
        return make, reference, verify, work

    if family == "route":
        n, d, L = dims["rows"], dims["features"], dims["lanes"]
        binned = ints(0, 33, (n, d))
        idx = ints(0, d, (L, n))

        def make(params):
            if card:
                p = KR.plan(L, n, d, params=params)
                return lambda: KR.launch(binned, idx, p)
            return lambda: KR.row_select_lanes_torch(binned, idx,
                                                     chunk=int(params["chunk"]))

        def reference():
            return KR.row_select_lanes_torch(binned, idx)

        def verify(out, ref):
            return out.shape == ref.shape and torch.equal(out, ref)

        return make, reference, verify, {"bytes": KR.bound_bytes(L, n, d), "ops": 0}

    if family == "encode":
        n, slots, width = dims["rows"], dims["slots"], dims["width"]
        table = KE.plan_slots(_encode_specs(KE, slots, width))
        inputs = []
        for s in table.specs:
            if s.kind == KE.ONEHOT:
                inputs.append(ints(-1, s.width + 1, (n,)))
            else:
                x = torch.randn((n,), generator=g, device=dev)
                inputs.append(torch.where(x > 1.5, torch.nan, x))

        def make(params):
            if card:
                cap = KE.grid_cap_of(params)
                out = torch.empty((n, table.width), dtype=torch.float32, device=dev)
                return lambda: KE.launch_table(inputs, table, out, cap)
            return lambda: KE.encode_slots_torch(inputs, table)

        def reference():
            return KE.encode_slots_torch(inputs, table)

        def verify(out, ref):
            return out.shape == ref.shape and torch.equal(out, ref)

        work = {"bytes": 4 * (n * len(table) + len(table.splits) + n * table.width),
                "ops": 0}
        return make, reference, verify, work

    raise ValueError(f"unknown autotune family {family!r}")


def _pick(trials: List[Dict[str, Any]], defaults: Dict[str, Any]
          ) -> Tuple[Dict[str, Any], Optional[float], Optional[float]]:
    """(winner params, its seconds, the default's seconds) of a sweep's
    verified trials (each with ``seconds``, the min of its ``reps``).  The
    fastest candidate replaces the default only where its slowest rep beats
    the default's fastest: a gain inside the reps' spread is run noise, and
    adopting it would move the cache token (and every artifact key) for
    nothing.  With no timed default, the fastest wins."""
    timed = [t for t in trials if t.get("verified") and t.get("seconds") is not None]
    default = next((t for t in timed if t["params"] == defaults), None)
    if not timed:
        return dict(defaults), None, None
    best = min(timed, key=lambda t: t["seconds"])
    if default is None:
        return dict(best["params"]), best["seconds"], None
    if best is not default and max(best["reps"]) < default["seconds"]:
        return dict(best["params"]), best["seconds"], default["seconds"]
    return dict(defaults), default["seconds"], default["seconds"]


def _time_rep(run, dev: torch.device, per: int) -> float:
    """Seconds a call over ``per`` back-to-back calls: on the card, CUDA
    events around them while a sleep kernel holds the stream as the host
    enqueues them (so the events time the device's work, not the host's
    launch cost); on the CPU, the host clock."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HOLD_CYCLES)
        start.record()
        for _ in range(per):
            run()
        end.record()
        end.synchronize()  # opcheck: allow(TM301) a tuning sweep times a rep with CUDA events
        return start.elapsed_time(end) / 1e3 / per
    t0 = time.perf_counter()
    for _ in range(per):
        run()
    return (time.perf_counter() - t0) / per


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def sweep(family: str, dims: Optional[Dict[str, int]] = None, *,
          store: Optional[str] = None, device=None,
          reps: int = _SWEEP_REPS) -> TuneDecision:
    """Time the bounded candidate grid for one family/shape class on
    ``device`` (default: the card, or where ``dispatch.use_device`` points),
    verify every candidate against the plain version there, persist and
    adopt the winner.

    Each candidate's first launch (and any kernel build or library load)
    is excluded; then the min of ``reps`` reps, each of enough back-to-back
    launches to last ~0.5 ms (at most 20), timed on the card by CUDA events
    with the stream held while the host enqueues them.  An unverified or
    failing candidate is ineligible.  The fastest candidate wins only where
    it beats the default by more than run noise (:func:`_pick`).  Returns
    the swept decision (source ``"swept"``)."""
    global _SWEEPS
    if family not in DEFAULT_DIMS:
        raise ValueError(f"unknown autotune family {family!r} "
                         f"(known: {', '.join(FAMILIES)})")
    dims = dict(DEFAULT_DIMS[family], **(dims or {}))
    dev = _dispatch.resolve_device(device)
    cls = shape_class(family, dev, **dims)
    kind = device_kind(dev)
    defaults = family_defaults(family, cls)
    make, reference, verify, work = _family_bench(family, dims, dev)
    ref = reference()

    eligible = 0
    trials: List[Dict[str, Any]] = []
    candidates = family_candidates(family, cls)
    for params in candidates:
        trial: Dict[str, Any] = {"params": params, "verified": False,
                                 "seconds": None}
        trials.append(trial)
        try:
            run = make(params)
            out = run()                      # first launch — excluded
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # opcheck: allow(TM301) a tuning sweep drains the card before timing
            if not verify(out, ref):
                log.warning("autotune: %s candidate %r differs from the plain "
                            "version — ineligible", family, params)
                continue
            del out
            probe = _time_rep(run, dev, 1)
            per = max(1, min(_REP_LAUNCHES, int(_REP_SECONDS / max(probe, 1e-7))))
            times = [_time_rep(run, dev, per) for _ in range(max(1, reps))]
        except Exception as exc:  # noqa: BLE001 — a candidate must not crash the sweep
            if _dispatch.is_kernel_fault(exc) and not isinstance(
                    exc, _dispatch.KernelError):
                raise                         # the device itself faulted
            log.warning("autotune: %s candidate %r failed (%s: %s) — "
                        "ineligible", family, params, type(exc).__name__, exc)
            trial["error"] = f"{type(exc).__name__}: {exc}"
            continue
        trial.update(verified=True, seconds=min(times), reps=times)
        eligible += 1

    best_params, best_dt, default_dt = _pick(trials, defaults)
    decision = TuneDecision(
        family=family, shape_class=cls, device_kind=kind,
        params=best_params, source="swept", verified=eligible > 0,
        candidates=len(candidates), best_seconds=best_dt,
        default_seconds=default_dt, eligible=eligible)
    entry = {
        "schema": SCHEMA_VERSION, "device_kind": kind, "family": family,
        "shape_class": cls, "params": best_params,
        "verified": decision.verified, "candidates": len(candidates),
        "eligible": eligible, "best_seconds": best_dt,
        "default_seconds": default_dt, "swept_unix": round(time.time(), 3),
        "dims": dims, "work": work, "trials": trials,
    }
    try:
        _write_atomic(_entry_path(kind, family, cls, store), entry)
    except OSError as exc:  # pragma: no cover — read-only store
        log.warning("autotune: could not persist %s winner: %s", family, exc)
    with _GUARD_LOCK:
        _SWEEPS += 1
        _MEMO[(kind, family, cls)] = decision
        _push_token_locked()
    return decision


# ---------------------------------------------------------------------------
# Adoption: memoized store reads, the cache-token component
# ---------------------------------------------------------------------------

def _decision_of(entry: Dict[str, Any], source: str = "cached") -> TuneDecision:
    return TuneDecision(
        family=str(entry["family"]), shape_class=str(entry["shape_class"]),
        device_kind=str(entry["device_kind"]), params=dict(entry["params"]),
        source=source, verified=True,
        candidates=int(entry.get("candidates", 0)),
        best_seconds=entry.get("best_seconds"),
        default_seconds=entry.get("default_seconds"),
        eligible=int(entry.get("eligible", 0)))


def _load_store_locked(root: str) -> None:
    """Bulk-adopt every verified winner for this process's devices from
    ``root`` into the in-process memo (once per store dir).  Caller holds
    _GUARD_LOCK."""
    if root in _LOADED_DIRS:
        return
    _LOADED_DIRS.add(root)  # opcheck: allow(TM306) every caller holds _GUARD_LOCK (the _locked suffix)
    kinds = _local_kinds()
    try:
        names = sorted(os.listdir(root))
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".json"):
            continue
        entry = _read_entry(os.path.join(root, name))
        if entry is None or entry.get("device_kind") not in kinds:
            continue
        try:
            dec = _decision_of(entry)
        except (KeyError, TypeError, ValueError):
            continue
        key = (dec.device_kind, dec.family, dec.shape_class)
        if key not in _MEMO:
            _MEMO[key] = dec  # opcheck: allow(TM306) every caller holds _GUARD_LOCK (the _locked suffix)
    _push_token_locked()


def _push_token_locked() -> None:
    """Recompute the cache-token component from every adopted non-default
    winner and invalidate the launchers' resolved winners.  Caller holds
    _GUARD_LOCK."""
    global _GENERATION, _TOKEN, _TUNED
    _GENERATION += 1
    _LAUNCH_CACHE.clear()  # opcheck: allow(TM306) every caller holds _GUARD_LOCK (the _locked suffix)
    tuned = {}
    for (device, family, cls), dec in _MEMO.items():
        if dec.source in ("cached", "swept") and not _is_default_safe(dec):
            tuned[f"{device}|{family}|{cls}"] = dec.params
    _TUNED = bool(tuned)
    if not tuned:
        _TOKEN = ""
        return
    blob = json.dumps(tuned, sort_keys=True).encode()
    _TOKEN = f"tune={hashlib.blake2b(blob, digest_size=6).hexdigest()}"


def _is_default_safe(dec: TuneDecision) -> bool:
    try:
        return dec.is_default()
    except (KeyError, ValueError):   # a class whose dims no plan takes
        return False


def tuning_token() -> str:
    """Load-the-store-then-report: the ``tune=<digest>`` cache-token
    component over every adopted non-default winner ("" when untuned).
    ``dispatch.cache_token()`` calls this, so any plan fingerprint computed
    after this point reflects the winners its launches can observe."""
    with _GUARD_LOCK:
        _load_store_locked(store_dir())
        return _TOKEN


def lookup(family: str, shape_cls: str, device=None) -> Optional[TuneDecision]:
    """The adopted decision for a triple (``device``'s kind), loading the
    store on first use; None when the store has no verified winner.  Never
    sweeps."""
    kind = device_kind(device)
    with _GUARD_LOCK:
        _load_store_locked(store_dir())
        return _MEMO.get((kind, family, shape_cls))


def launch_params(family: str, device: torch.device,
                  **dims: int) -> Optional[Dict[str, Any]]:
    """What a launcher calls: the adopted winner's params for the class of
    a launch of ``family`` on ``device`` with ``dims``, or None without one
    (or with a winner equal to the class's default: the rules' plan is
    that plan).  Resolved once per class and adoption generation (a dict
    lookup on the launch path afterwards; with no non-default winner
    adopted from the store, not even that); never sweeps."""
    root = store_dir()
    if not _TUNED and root in _LOADED_DIRS:
        return None
    key = (family, device.type, device.index, root,
           tuple(sorted((k, _log2_bucket(v) if k in ("rows", "n") else int(v))
                        for k, v in dims.items())))
    hit = _LAUNCH_CACHE.get(key)
    if hit is not None and hit[0] == _GENERATION and root in _LOADED_DIRS:
        return hit[1]
    cls = shape_class(family, device, **dims)
    dec = lookup(family, cls, device)
    params = dict(dec.params) if dec is not None and not _is_default_safe(dec) \
        else None
    with _GUARD_LOCK:
        _LAUNCH_CACHE[key] = (_GENERATION, params)
    return params


def applied(family: str) -> None:
    """Count one launch of ``family`` that took an adopted winner's plan
    (the launchers call it; :func:`applied_counts` reads it)."""
    with _GUARD_LOCK:
        _APPLIED[family] = _APPLIED.get(family, 0) + 1


def applied_counts(reset: bool = False) -> Dict[str, int]:
    """Launches by family that took an adopted non-default winner since the
    last reset (``reset`` zeroes them after reading)."""
    with _GUARD_LOCK:
        out = dict(_APPLIED)
        if reset:
            _APPLIED.clear()
    return out


def misfit(family: str, params: Dict[str, Any], shape: Any,
           exc: BaseException) -> None:
    """Log (once per family, params and shape) a winner that does not fit
    a launch's actual shape; the launcher then runs its default plan."""
    key = (family, json.dumps(params, sort_keys=True), repr(shape))
    with _GUARD_LOCK:
        if key in _MISFITS:
            return
        _MISFITS.add(key)
    log.warning("autotune: %s winner %r does not fit the launch %s (%s) — "
                "the default plan runs", family, params, shape, exc)


def ensure_tuned(family: str, dims: Optional[Dict[str, int]] = None, *,
                 sweep_on_miss: Optional[bool] = None,
                 store: Optional[str] = None, device=None) -> TuneDecision:
    """First-contact entry point: memo -> warm store -> (optionally) ONE
    sweep -> defaults.

    ``sweep_on_miss=None`` resolves from ``TMOG_AUTOTUNE``; two threads
    racing the same cold triple serialize on a per-key lock and the loser
    adopts the winner's result: exactly one sweep, no torn store writes."""
    if family not in DEFAULT_DIMS:
        raise ValueError(f"unknown autotune family {family!r} "
                         f"(known: {', '.join(FAMILIES)})")
    dims = dict(DEFAULT_DIMS[family], **(dims or {}))
    dev = _device(device)
    cls = shape_class(family, dev, **dims)
    kind = device_kind(dev)
    key = (kind, family, cls)
    if sweep_on_miss is None:
        sweep_on_miss = os.environ.get("TMOG_AUTOTUNE", "").strip() \
            in ("1", "on", "true", "sweep")
    with _GUARD_LOCK:
        _load_store_locked(store or store_dir())
        hit = _MEMO.get(key)
        if hit is not None:
            return hit
        klock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with klock:
        with _GUARD_LOCK:
            hit = _MEMO.get(key)
            if hit is not None:          # the racing sweep already landed
                return hit
        entry = _read_entry(_entry_path(kind, family, cls, store))
        if entry is not None:
            dec = _decision_of(entry)
        elif sweep_on_miss:
            return sweep(family, dims, store=store, device=dev)
        else:
            dec = TuneDecision(
                family=family, shape_class=cls, device_kind=kind,
                params=family_defaults(family, cls), source="default")
        with _GUARD_LOCK:
            _MEMO[key] = dec
            _push_token_locked()
        return dec


def provenance() -> Dict[str, Any]:
    """The ``tuning`` provenance block: token, store, and every adopted
    winner with its source (``default`` entries are omitted — absence IS
    the default)."""
    with _GUARD_LOCK:
        _load_store_locked(store_dir())
        adopted = {
            f"{family}/{cls}": {"params": dict(dec.params),
                                "source": dec.source}
            for (_dev, family, cls), dec in sorted(_MEMO.items())
            if dec.source != "default"
        }
        token = _TOKEN
    return {
        "token": token,
        "store": store_dir(),
        "winners": adopted,
        "sweeps_this_process": sweep_count(),
    }
