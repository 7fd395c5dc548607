"""TM31x concurrency analyzer on the port: the JAX package's
``tests/test_threadcheck.py`` with its imports swapped to
``transmogrifai_tpu_torch`` and its self-host pass pointed at the port's
threaded surface — lockset/guarded-by inference, lock-order deadlock graph,
and blocking-under-lock detection (checkers/threadcheck.py).

Discipline mirrored from test_plancheck.py: every seeded fixture fires
exactly its own code, every quiet fixture stays silent, and the whole
analysis is pure AST work — the compile probe must read ZERO backend
compiles across a full self-host pass.  The regression tests at the bottom
pin the races the analyzer surfaced in the serving stack (prefetch stats
accumulators, flight-recorder counter snapshot, fault-harness schedule
edits, and in the port the scoring plan's staging table) as behavioral
tests, not just lint assertions.  At the end: the port's analyzer over the
JAX package's own threaded surface gives exactly the reference analyzer's
findings and thread model, and TM315 sees torch's device syncs.
"""

import os
import threading
import time

import pytest

from transmogrifai_tpu_torch.checkers.threadcheck import (
    analyze_files,
    analyze_source,
    module_global_findings,
)
from transmogrifai_tpu_torch.perf.timers import measure_compiles

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO_ROOT, "transmogrifai_tpu_torch")


def codes(src, filename="fixture.py"):
    return sorted({f.code for f in analyze_source(src, filename).findings})


# ---------------------------------------------------------------------------
# seeded one-shot fixtures: each fires exactly its own code
# ---------------------------------------------------------------------------

TM311_FIXTURE = '''
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        while True:
            with self._lock:
                self._total = self._total + 1

    def snapshot(self):
        return self._total
'''

TM312_FIXTURE = '''
import threading

class Counter:
    def __init__(self):
        self._n = 0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        self._n += 1

    def bump(self):
        self._n += 1
'''

TM313_FIXTURE = '''
import threading

_A_LOCK = threading.Lock()
_B_LOCK = threading.Lock()

def forward():
    with _A_LOCK:
        with _B_LOCK:
            pass

def backward():
    with _B_LOCK:
        with _A_LOCK:
            pass
'''

TM314_FIXTURE = '''
import threading

class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self._num = 0.0
        self._den = 1.0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        with self._lock:
            self._num = 1.0
            self._den = 2.0

    def ratio(self):
        return self._num / self._den
'''

TM315_FIXTURE = '''
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run)

    def _run(self):
        with self._lock:
            pass

    def stop(self):
        with self._lock:
            self._thread.join()
'''

SEEDED = {
    "TM311": TM311_FIXTURE,
    "TM312": TM312_FIXTURE,
    "TM313": TM313_FIXTURE,
    "TM314": TM314_FIXTURE,
    "TM315": TM315_FIXTURE,
}


@pytest.mark.parametrize("code", sorted(SEEDED))
def test_seeded_fixture_fires_exactly_its_own_code(code):
    assert codes(SEEDED[code]) == [code]


def test_seeded_fixtures_carry_both_sites():
    """TM311/TM314 messages name the guarded counter-site, TM313 the full
    cycle path with per-edge sites, TM315 the held lock."""
    f311 = analyze_source(TM311_FIXTURE, "f.py").findings[0]
    assert "line" in f311.message and "Counter._lock" in f311.message
    f313 = analyze_source(TM313_FIXTURE, "f.py").findings[0]
    assert "f:_A_LOCK" in f313.message and "f:_B_LOCK" in f313.message
    f315 = analyze_source(TM315_FIXTURE, "f.py").findings[0]
    assert "Worker._lock" in f315.message


# ---------------------------------------------------------------------------
# quiet-on-correct-code fixtures: the fixed version of each hazard is silent
# ---------------------------------------------------------------------------

QUIET = {
    # TM311: every access of the shared attr holds the guard
    "TM311": '''
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        while True:
            with self._lock:
                self._total = self._total + 1

    def snapshot(self):
        with self._lock:
            return self._total
''',
    # TM312: the read-modify-write takes a lock on both sides
    "TM312": '''
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        with self._lock:
            self._n += 1

    def bump(self):
        with self._lock:
            self._n += 1
''',
    # TM313: both paths honor one global acquisition order
    "TM313": '''
import threading

_A_LOCK = threading.Lock()
_B_LOCK = threading.Lock()

def forward():
    with _A_LOCK:
        with _B_LOCK:
            pass

def also_forward():
    with _A_LOCK:
        with _B_LOCK:
            pass
''',
    # TM314: the multi-field read snapshots under the writers' lock
    "TM314": '''
import threading

class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self._num = 0.0
        self._den = 1.0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        with self._lock:
            self._num = 1.0
            self._den = 2.0

    def ratio(self):
        with self._lock:
            return self._num / self._den
''',
    # TM315: the join happens after the lock is released
    "TM315": '''
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run)

    def _run(self):
        with self._lock:
            pass

    def stop(self):
        with self._lock:
            pass
        self._thread.join()
''',
}


@pytest.mark.parametrize("code", sorted(QUIET))
def test_quiet_fixture_is_silent(code):
    assert codes(QUIET[code]) == []


# ---------------------------------------------------------------------------
# analyzer semantics worth pinning individually
# ---------------------------------------------------------------------------

def test_condition_aliasing_no_false_positive():
    """``Condition(self._lock)`` canonicalizes to the underlying lock, so a
    ``with self._cond:`` access site counts as holding ``_lock``."""
    src = '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items = []
        self._t = threading.Thread(target=self._run)

    def _run(self):
        with self._cond:
            self._items.append(1)

    def drain(self):
        with self._lock:
            out = list(self._items)
            self._items.clear()
        return out
'''
    assert codes(src) == []


def test_caller_holds_lock_helper_suffix():
    """A ``*_locked`` helper is analyzed as entered with the primary lock
    held (the repo's documented caller-holds-lock convention)."""
    src = '''
import threading

class Ledger:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._t = threading.Thread(target=self._run)

    def _run(self):
        with self._lock:
            self._bump_locked()

    def _bump_locked(self):
        self._n += 1

    def read(self):
        with self._lock:
            return self._n
'''
    assert codes(src) == []


def test_init_construction_happens_before_excluded():
    """Unlocked writes in ``__init__`` AND in private helpers called only
    from it never count: construction happens-before any second thread."""
    src = '''
import threading

class Plan:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries = []
        self._build()

    def _build(self):
        self._entries.append(1)
        self._entries.append(2)

    def read(self):
        with self._lock:
            return list(self._entries)

    def grow(self):
        with self._lock:
            self._entries.append(3)
'''
    assert codes(src) == []


def test_declared_concurrent_class_without_own_thread():
    """RacerD's declared-concurrency assumption: a class that constructs its
    own lock is analyzed even with no ``Thread(target=...)`` of its own."""
    src = '''
import threading

class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def bump(self):
        self._n += 1

    def read(self):
        with self._lock:
            return self._n
'''
    assert codes(src) == ["TM312"]


def test_loop_header_reads_are_access_sites():
    """``for x in self._items:`` is a read of the shared list (the gap that
    originally hid the fault-harness ``_rules`` race)."""
    src = '''
import threading

class H:
    def __init__(self):
        self._lock = threading.Lock()
        self._rules = []

    def add(self, r):
        self._rules.append(r)

    def check(self):
        with self._lock:
            for r in self._rules:
                pass
'''
    assert codes(src) == ["TM312"]


def test_lock_order_cycle_across_modules():
    """TM313 edges merge across files: each module alone is cycle-free."""
    fwd = '''
import threading
from locks import A_LOCK, B_LOCK

def forward():
    with A_LOCK:
        with B_LOCK:
            pass
'''
    bwd = '''
import threading
from locks import A_LOCK, B_LOCK

def backward():
    with B_LOCK:
        with A_LOCK:
            pass
'''
    import ast
    from transmogrifai_tpu_torch.checkers.threadcheck import analyze_parsed

    one = analyze_parsed([(fwd, "fwd.py", ast.parse(fwd))])
    assert [f.code for f in one.findings] == []
    both = analyze_parsed([(fwd, "fwd.py", ast.parse(fwd)),
                           (bwd, "bwd.py", ast.parse(bwd))])
    assert sorted({f.code for f in both.findings}) == ["TM313"]


def test_inline_allow_marker_suppresses():
    src = TM312_FIXTURE.replace(
        "self._n += 1\n\n    def bump",
        "self._n += 1  # opcheck: allow(TM312) single-writer by design\n\n"
        "    def bump")
    found = codes(src)
    # only the un-marked bump() site remains
    assert found == ["TM312"]
    all_marked = TM312_FIXTURE.replace(
        "self._n += 1",
        "self._n += 1  # opcheck: allow(TM312) single-writer by design")
    assert codes(all_marked) == []


def test_tm306_delegation_identical_through_both_entry_points():
    """opcheck.lint_module_concurrency is a delegate of the threadcheck
    engine: same findings, same code, same allow-marker handling."""
    from transmogrifai_tpu_torch.checkers.opcheck import lint_module_concurrency

    src = '''
import threading

_CACHE = {}
_LOCK = threading.Lock()

def racy(key, value):
    _CACHE[key] = value

def safe(key, value):
    with _LOCK:
        _CACHE[key] = value
'''
    a = [(f.code, f.qualname, f.lineno) for f in
         lint_module_concurrency(src, filename="m.py")]
    b = [(f.code, f.qualname, f.lineno) for f in
         module_global_findings(src, filename="m.py")]
    assert a == b
    assert [c for c, _q, _l in a] == ["TM306"]


# ---------------------------------------------------------------------------
# self-host: the analyzer over its own serving stack, at zero compiles
# ---------------------------------------------------------------------------

def _threaded_surface_paths():
    paths = []
    for d in ("serve", "obs", "perf", os.path.join("perf", "kernels"),
              "checkers", "deploy"):
        full = os.path.join(PKG, d)
        paths += sorted(os.path.join(full, f) for f in os.listdir(full)
                        if f.endswith(".py"))
    paths += [os.path.join(PKG, "workflow", "continual.py"),
              os.path.join(PKG, "workflow", "resilience.py"),
              os.path.join(PKG, "readers", "prefetch.py"),
              os.path.join(PKG, "data", "chunked.py")]
    return paths


def test_self_host_zero_findings_at_zero_compiles():
    """The acceptance gate: the full threaded surface analyzes clean (every
    finding fixed or justified inline) and the probe reads 0 compiles."""
    with measure_compiles() as c:
        analysis = analyze_files(_threaded_surface_paths())
    assert c.backend_compiles == 0
    assert analysis.findings == [], [
        f"{f.code} {f.filename}:{f.lineno} {f.message}"
        for f in analysis.findings]


def test_self_host_thread_model_is_nontrivial():
    """Discovery must actually see the serving stack's structure — a model
    that found nothing would mean the gate gates nothing."""
    model = analyze_files(_threaded_surface_paths()).model.to_dict()
    targets = {t["target"] for t in model["threads"]}
    assert {"MicroBatcher._run", "SwappableScorer._shadow_worker",
            "ChunkPrefetcher._run"} <= targets
    assert {"MicroBatcher", "SwappableScorer",
            "ChunkPrefetcher"} <= set(model["sharedClasses"])
    edges = {tuple(e) for e in model["lockOrderEdges"]}
    assert ("ModelRegistry._admission_lock",
            "ModelRegistry._lock") in edges
    assert len(edges) >= 3


# ---------------------------------------------------------------------------
# regression tests for the races the analyzer surfaced
# ---------------------------------------------------------------------------

def test_prefetch_stats_concurrent_accumulation_is_exact():
    """TM312 fix: PrefetchStats accumulators are lock-guarded, so no
    increment is lost under worker/consumer contention."""
    from transmogrifai_tpu_torch.readers.prefetch import PrefetchStats

    stats = PrefetchStats()
    N, K = 8, 500

    def worker():
        for _ in range(K):
            stats.add_load(0.001)
            stats.add_wait(0.0005, stalled=True)
            stats.add_chunk()

    threads = [threading.Thread(target=worker) for _ in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = stats.to_dict()
    assert snap["chunks"] == N * K
    assert snap["stalls"] == N * K
    assert snap["load_seconds"] == pytest.approx(N * K * 0.001)
    assert snap["wait_seconds"] == pytest.approx(N * K * 0.0005)


def test_flight_payload_counters_consistent_with_events():
    """TM314 fix: to_payload snapshots dropped/unexpected_compiles under the
    same lock as the event ring, so ``dropped == last seq - len(events)``
    holds in EVERY concurrent snapshot (stale unlocked counter reads used to
    break it)."""
    from transmogrifai_tpu_torch.obs.flight import FlightRecorder

    rec = FlightRecorder(capacity=4)
    stop = threading.Event()
    bad = []

    def hammer():
        while not stop.is_set():
            rec.record("tick")

    def snapshot():
        while not stop.is_set():
            p = rec.to_payload()
            if p["events"]:
                want = p["events"][-1]["seq"] - len(p["events"])
                if p["dropped"] != want:
                    bad.append((p["dropped"], want))

    writers = [threading.Thread(target=hammer) for _ in range(3)]
    reader = threading.Thread(target=snapshot)
    for t in writers + [reader]:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in writers + [reader]:
        t.join()
    assert not bad, f"torn payload snapshots: {bad[:5]}"


def test_fault_harness_schedule_edits_race_free():
    """TM312 fix: script()/fail_when() take the harness lock, so schedule
    edits concurrent with firing lose no entries."""
    from transmogrifai_tpu_torch.serve.faults import FaultHarness

    h = FaultHarness()
    N, K = 4, 200

    def scripter(i):
        for k in range(K):
            h.script(f"point-{i}", [None])
            h.fail_when(f"point-{i}", lambda ctx: False, RuntimeError,
                        times=1)

    def firer():
        for _ in range(N * K):
            h._check("point-0", {})

    threads = [threading.Thread(target=scripter, args=(i,))
               for i in range(N)] + [threading.Thread(target=firer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(h._scripts) == N
    for i in range(N):
        assert len(h._scripts[f"point-{i}"]) == K
    assert len(h._rules) == N * K
    assert h.calls["point-0"] == N * K


def test_fixed_race_sites_stay_clean():
    """The modules the analyzer's fixes touched analyze clean individually
    — a revert of any fix re-fires its TM31x code here, next to the fix."""
    fixed = [os.path.join(PKG, "readers", "prefetch.py"),
             os.path.join(PKG, "obs", "flight.py"),
             os.path.join(PKG, "serve", "faults.py"),
             os.path.join(PKG, "serve", "plan.py"),
             os.path.join(PKG, "serve", "registry.py")]
    analysis = analyze_files(fixed)
    assert analysis.findings == [], [
        f"{f.code} {f.filename}:{f.lineno}" for f in analysis.findings]


def test_staging_table_read_holds_the_plan_lock():
    """TM311 fix in the port: ``_hold_staging`` read the plan's own staging
    table without the plan's lock while ``release_executables`` cleared it
    under that lock alone, so a release racing a batch could count a
    bucket's buffers as freed while the batch scored through them.  Every
    read of the table now holds the lock (the lookup runs here with a dict
    that checks it)."""
    import numpy as np

    from transmogrifai_tpu_torch.checkers.irsnap import _plan_fixture_runners, _Shim
    from transmogrifai_tpu_torch.serve.plan import CompiledScoringPlan

    features, _ = _plan_fixture_runners()
    plan = CompiledScoringPlan(_Shim(features, {}), min_bucket=8, max_bucket=8,
                               strict=False, device="cpu")

    class _Checked(dict):
        def get(self, *a):
            assert plan._lock.locked(), "the staging table read without its lock"
            return super().get(*a)

    plan._staging = _Checked()
    entry = plan._shared()
    with entry.lock:
        plan._hold_staging(entry, 8, (np.dtype("float32"),))
    assert 8 in plan._staging


def test_tm315_sees_torch_device_syncs():
    """TM315's device syncs include torch's: ``synchronize()``, ``.item()``
    and ``.cpu()`` under a held lock block the lock's every other user."""
    for call in ("torch.cuda.synchronize()", "self._ev.synchronize()",
                 "self._t.item()", "self._t.cpu()"):
        src = f"""
import threading
import torch

class Scorer:
    def __init__(self):
        self._lock = threading.Lock()
        self._t = None
        self._ev = None
        self._thread = threading.Thread(target=self._run)

    def _run(self):
        with self._lock:
            {call}
"""
        assert codes(src) == ["TM315"], call


# ---------------------------------------------------------------------------
# parity: the port's analyzer over the JAX package's own threaded surface
# ---------------------------------------------------------------------------

def test_reference_surface_equals_the_reference_analyzer():
    """The analyzer is copied whole: over the JAX package's threaded surface
    (its own self-host list) the port's findings and thread model equal the
    reference analyzer's exactly."""
    from transmogrifai_tpu.checkers.threadcheck import analyze_files as j_analyze

    ref = os.path.join(REPO_ROOT, "transmogrifai_tpu")
    paths = []
    for d in ("serve", "obs", "parallel", "perf", os.path.join("perf", "kernels"),
              "checkers", "deploy"):
        full = os.path.join(ref, d)
        paths += sorted(os.path.join(full, f) for f in os.listdir(full)
                        if f.endswith(".py"))
    paths += [os.path.join(ref, "workflow", "continual.py"),
              os.path.join(ref, "workflow", "resilience.py"),
              os.path.join(ref, "readers", "prefetch.py"),
              os.path.join(ref, "data", "chunked.py")]
    got, want = analyze_files(paths), j_analyze(paths)

    def key(a):
        return sorted((f.code, f.filename, f.lineno, f.qualname, f.message)
                      for f in a.findings)

    assert key(got) == key(want)
    assert got.model.to_dict() == want.model.to_dict()
    assert {t["target"] for t in got.model.to_dict()["threads"]} >= {
        "MicroBatcher._run", "SwappableScorer._shadow_worker", "ChunkPrefetcher._run"}


def test_placement_and_bin_caches_mutate_under_their_locks():
    """TM306 fix in the port: the feature block's placement cache
    (``parallel/mesh.py``'s ``_PLACED_ROWS_CACHE``, which
    ``models/base.py::place_rows`` goes through) and
    ``models/trees.py::shared_binned``'s ``_BIN_CACHE`` are read, written and
    evicted (``pop(next(iter(...)))``) by trainers on several threads (a
    refit beside a fit): every access holds the cache's lock (checked here
    by dicts that assert it on each access)."""
    import numpy as np
    import torch

    from transmogrifai_tpu_torch.models import base as MB
    from transmogrifai_tpu_torch.models import trees as MT
    from transmogrifai_tpu_torch.parallel import mesh as PM

    def holds(lock):
        # an RLock knows its owner; a Lock only that it is held
        return lock._is_owned() if hasattr(lock, "_is_owned") else lock.locked()

    class _Checked(dict):
        def __init__(self, lock):
            super().__init__()
            self._lock = lock

        def _held(self):
            assert holds(self._lock), "a shared cache touched without its lock"

        def get(self, *a):
            self._held()
            return super().get(*a)

        def __setitem__(self, k, v):
            self._held()
            super().__setitem__(k, v)

        def pop(self, *a):
            self._held()
            return super().pop(*a)

    saved = PM._PLACED_ROWS_CACHE, MT._BIN_CACHE
    PM._PLACED_ROWS_CACHE = _Checked(PM._PLACEMENT_LOCK)
    MT._BIN_CACHE = _Checked(MT._BIN_CACHE_LOCK)
    try:
        blocks = [np.random.default_rng(i).normal(size=(16, 3)).astype(np.float32)
                  for i in range(4)]
        # past _PLACED_ROWS_CACHE_MAX: evicts
        placed = [MB.place_rows(b, "cpu") for b in blocks]
        assert MB.place_rows(blocks[-1], "cpu") is placed[-1]
        for x in placed:                                     # past _BIN_CACHE_MAX
            MT.shared_binned(x.numpy(), x, 8)
        codes, _edges = MT.shared_binned(placed[-1].numpy(), placed[-1], 8)
        assert codes.dtype == torch.int32
    finally:
        PM._PLACED_ROWS_CACHE, MT._BIN_CACHE = saved
