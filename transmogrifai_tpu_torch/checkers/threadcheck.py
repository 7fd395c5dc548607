"""TM31x whole-program concurrency analyzer — lockset / guarded-by inference
(the reference's ``transmogrifai_tpu/checkers/threadcheck.py``, copied whole:
a pure AST analysis, which does not depend on the framework; TM315's device
syncs gain torch's ``synchronize``, ``.item()`` and ``.cpu()``).

Reference: the guarded-by/lockset lineage of RacerD (Blackshear et al.) and
the classic Eraser lockset algorithm (Savage et al.), specialized as a pure
AST analysis — zero execution, ZERO backend compiles — to the threading
idioms this repo actually uses (SURVEY §1; docs/static_analysis.md):

- ``threading.Thread(target=self._run)`` background workers owned by a class
  (the MicroBatcher flusher, the SwappableScorer shadow worker, the
  ChunkPrefetcher worker);
- ``with self._lock:`` critical sections, with
  ``threading.Condition(self._lock)`` aliasing — acquiring the condition
  acquires the underlying lock, so ``with self._wake:`` counts as holding
  ``self._lock``;
- caller-holds-lock helper methods, recognized by the ``*_locked`` naming
  convention or inferred when EVERY intra-class call site holds the lock;
- module-level ``_CACHE``/``_LOCK`` pairs — the TM306 rule's domain, whose
  engine now lives here (:func:`module_global_findings`) so the shallow
  module-global rule and the class lockset rule cannot drift.

The typed family:

- **TM311** inconsistent lockset: a shared attribute is accessed both under
  and outside its inferred guard (the intersection of locks held at every
  write site).
- **TM312** unlocked read-modify-write: ``self._n += 1`` / in-place container
  mutation of a shared attribute with no common guard at all.
- **TM313** lock-order cycle: the global acquired-while-held graph (built
  across every analyzed file, through intra-class calls and
  constructor-resolved cross-class attribute calls) contains a cycle — a
  potential deadlock.  A self-edge on a non-reentrant lock (re-acquiring a
  ``Lock`` you already hold, directly or through a ``Condition`` alias) is a
  guaranteed deadlock and reports the same code.
- **TM314** torn multi-field read: writers update several attributes
  together under a lock, but one statement reads two or more of them with no
  lock held and can observe a half-updated pair.
- **TM315** blocking call under a held lock: ``Queue.get/put`` (blocking
  forms), ``Thread.join``, ``future.result()``, ``Condition.wait`` on a
  *different* lock, ``Event.wait``, ``time.sleep`` and
  ``block_until_ready``/``device_get`` device syncs (and torch's
  ``synchronize``, ``.item()``, ``.cpu()``) while holding a lock.

Every diagnostic message carries both sites (the guarded/acquire site and
the offending access site).  Findings on a line carrying an inline
``# opcheck: allow(TM31x) <reason>`` marker are suppressed, same contract as
every other opcheck rule.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .opcheck import (
    LintFinding,
    _ALLOW_RE,
    _MUTATOR_METHODS,
    _attr_chain,
    _is_mutable_ctor,
    _iter_functions,
    _looks_like_lock,
)

__all__ = [
    "ThreadAnalysis",
    "ThreadModel",
    "analyze_files",
    "analyze_parsed",
    "analyze_source",
    "module_global_findings",
]

#: threading-module constructor names, resolved by last dotted segment
_LOCK_CTORS = frozenset({"Lock", "RLock"})
_COND_CTORS = frozenset({"Condition"})
_EVENT_CTORS = frozenset({"Event"})
_SEM_CTORS = frozenset({"Semaphore", "BoundedSemaphore"})
_QUEUE_CTORS = frozenset({"Queue", "SimpleQueue", "LifoQueue",
                          "PriorityQueue"})
_THREAD_CTORS = frozenset({"Thread"})

#: device-sync call chains that block the calling thread until the
#: accelerator drains — catastrophic while a serving lock is held (the JAX
#: forms, so the analyzer reads the reference's sources as the reference's
#: analyzer does, and torch's: ``torch.cuda.synchronize``,
#: ``Event``/``Stream.synchronize``, ``.item()``, ``.cpu()``)
_DEVICE_SYNC_ATTRS = frozenset({"block_until_ready", "device_get",
                                "synchronize", "item", "cpu"})


def _ctor_last_segment(value: ast.AST) -> Optional[str]:
    """Last dotted segment of a Call's func ('threading.Lock' -> 'Lock')."""
    if not isinstance(value, ast.Call):
        return None
    chain = _attr_chain(value.func)
    if chain is None:
        return None
    return chain.rsplit(".", 1)[-1]


def _iter_ctor_candidates(value: ast.AST):
    """Yield Call nodes a ``self.x = ...`` value may construct from —
    sees through ``a or B()`` / ``B() if c else D()`` wrappers."""
    if isinstance(value, ast.Call):
        yield value
    elif isinstance(value, ast.BoolOp):
        for v in value.values:
            yield from _iter_ctor_candidates(v)
    elif isinstance(value, ast.IfExp):
        yield from _iter_ctor_candidates(value.body)
        yield from _iter_ctor_candidates(value.orelse)


@dataclass
class _ClassInfo:
    """Per-class synchronization inventory, built from one AST pass."""

    name: str
    filename: str
    module: str
    lineno: int
    locks: Dict[str, str] = field(default_factory=dict)  # attr -> lock|rlock
    cond_underlying: Dict[str, str] = field(default_factory=dict)
    events: Set[str] = field(default_factory=set)
    queues: Set[str] = field(default_factory=set)
    threads: Set[str] = field(default_factory=set)
    attr_types: Dict[str, str] = field(default_factory=dict)
    thread_targets: Set[str] = field(default_factory=set)
    thread_sites: List[Tuple[str, int]] = field(default_factory=list)
    init_written: Set[str] = field(default_factory=set)
    methods: Dict[str, ast.AST] = field(default_factory=dict)

    def sync_attrs(self) -> Set[str]:
        return (set(self.locks) | set(self.cond_underlying) | self.events
                | self.queues | self.threads)

    def primary_lock(self) -> Optional[str]:
        """The lock a ``*_locked`` helper's caller holds by convention."""
        if "_lock" in self.locks:
            return "_lock"
        if len(self.locks) == 1:
            return next(iter(self.locks))
        return None

    def canon(self, attr: str) -> str:
        """Canonical lock token for a self attr (condition -> its lock)."""
        return f"{self.name}.{self.cond_underlying.get(attr, attr)}"


@dataclass
class _ModuleInfo:
    """Module-level synchronization inventory (globals, functions)."""

    module: str
    filename: str
    locks: Dict[str, str] = field(default_factory=dict)  # NAME -> lock|rlock
    cond_underlying: Dict[str, str] = field(default_factory=dict)
    events: Set[str] = field(default_factory=set)
    thread_targets: Set[str] = field(default_factory=set)

    def canon(self, name: str) -> str:
        return f"{self.module}:{self.cond_underlying.get(name, name)}"


@dataclass(frozen=True)
class _Access:
    attr: str
    kind: str            # "read" | "write" | "rmw"
    lineno: int
    lockset: FrozenSet[str]
    method: str
    stmt_id: int         # statement grouping key, for the TM314 torn read


@dataclass
class _Blocking:
    desc: str
    lineno: int
    held: Tuple[Tuple[str, int], ...]   # (token, acquire lineno)
    releases: FrozenSet[str]            # locks the call releases while waiting


@dataclass
class _MethodScan:
    name: str
    qualname: str
    lineno: int
    accesses: List[_Access] = field(default_factory=list)
    self_calls: List[Tuple[str, FrozenSet[str], int]] = field(
        default_factory=list)
    attr_calls: List[Tuple[str, str, FrozenSet[str], int]] = field(
        default_factory=list)
    acquires: List[Tuple[str, Tuple[Tuple[str, int], ...], int]] = field(
        default_factory=list)
    blocking: List[_Blocking] = field(default_factory=list)
    waits_on: Set[str] = field(default_factory=set)
    callbacks: Set[str] = field(default_factory=set)


@dataclass(frozen=True)
class LockEdge:
    """``inner`` acquired while ``outer`` is held, at ``filename:lineno``."""

    outer: str
    inner: str
    filename: str
    lineno: int
    qualname: str


@dataclass
class ThreadModel:
    """What the discovery pass learned about the program's thread structure."""

    threads: List[Dict] = field(default_factory=list)
    shared_classes: List[str] = field(default_factory=list)
    waiters: List[str] = field(default_factory=list)
    callbacks: List[str] = field(default_factory=list)
    lock_order_edges: List[LockEdge] = field(default_factory=list)
    analyzed_files: int = 0

    def to_dict(self) -> Dict:
        return {
            "threads": list(self.threads),
            "sharedClasses": sorted(self.shared_classes),
            "waiters": sorted(self.waiters),
            "callbacks": sorted(self.callbacks),
            "lockOrderEdges": sorted(
                [e.outer, e.inner] for e in self.lock_order_edges),
            "analyzedFiles": self.analyzed_files,
        }


@dataclass
class ThreadAnalysis:
    """Findings + discovered thread model for one analyzed file set."""

    findings: List[LintFinding]
    model: ThreadModel


# ---------------------------------------------------------------------------
# per-method scan: accesses, locksets, acquisitions, blocking calls
# ---------------------------------------------------------------------------

class _MethodAnalyzer:
    """One function/method body: recursive statement walk carrying the set of
    held locks (``with`` scopes, condition aliasing) and recording every
    shared-attribute access with the lockset at that site."""

    def __init__(self, fn: ast.AST, qualname: str, ci: Optional[_ClassInfo],
                 mi: _ModuleInfo):
        self.fn = fn
        self.ci = ci
        self.mi = mi
        self.scan = _MethodScan(name=getattr(fn, "name", qualname),
                                qualname=qualname,
                                lineno=getattr(fn, "lineno", 0))
        self.held: List[Tuple[str, int]] = []
        self.local_types: Dict[str, str] = {}   # var -> ctor kind/class name
        self._stmt_counter = 0

    # -- lock canonicalization ----------------------------------------------
    def _lock_token(self, expr: ast.AST) -> Optional[str]:
        """Canonical token when ``expr`` names a lock/condition, else None."""
        if isinstance(expr, ast.Call):
            expr = expr.func
        chain = _attr_chain(expr)
        if chain is None:
            return None
        if chain.startswith("self.") and self.ci is not None:
            attr = chain[5:]
            if "." in attr:          # self.a.b — not a class-level lock attr
                return chain if _looks_like_lock(expr) else None
            if attr in self.ci.locks or attr in self.ci.cond_underlying:
                return self.ci.canon(attr)
            if _looks_like_lock(expr):
                return f"{self.ci.name}.{attr}"
            return None
        if "." not in chain:
            if chain in self.mi.locks or chain in self.mi.cond_underlying:
                return self.mi.canon(chain)
            if chain in self.local_types and \
                    self.local_types[chain] in ("lock", "rlock", "cond"):
                return f"{self.scan.qualname}:{chain}"
        if _looks_like_lock(expr):
            return chain
        return None

    def _lockset(self) -> FrozenSet[str]:
        return frozenset(t for t, _ in self.held)

    # -- driver --------------------------------------------------------------
    def run(self) -> _MethodScan:
        self._walk_body(getattr(self.fn, "body", []))
        return self.scan

    def _walk_body(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            tokens: List[str] = []
            for item in stmt.items:
                self._scan_exprs(item.context_expr)
                tok = self._lock_token(item.context_expr)
                if tok is not None:
                    self.scan.acquires.append(
                        (tok, tuple(self.held), stmt.lineno))
                    self.held.append((tok, stmt.lineno))
                    tokens.append(tok)
            self._walk_body(stmt.body)
            for _ in tokens:
                self.held.pop()
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a closure defined here runs later, NOT under the current locks
            saved, self.held = self.held, []
            self._walk_body(stmt.body)
            self.held = saved
            return
        if isinstance(stmt, (ast.If, ast.While, ast.For, ast.AsyncFor)):
            # the header expression is an access site of its own (e.g.
            # ``for r in self._rules:`` reads the shared list) and its own
            # TM314 grouping unit, separate from the loop/branch body
            header = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                else stmt.test
            self._stmt_counter += 1
            self._reads_in_expr_with_mutators(header)
            self._scan_exprs(header)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body)
            for h in stmt.handlers:
                self._walk_body(h.body)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
            return
        # simple statement: one TM314 grouping unit
        self._stmt_counter += 1
        self._record_local_types(stmt)
        self._record_accesses(stmt)
        self._scan_exprs(stmt)

    # -- local variable ctor types (Thread/Queue/lock locals) ----------------
    def _record_local_types(self, stmt: ast.stmt) -> None:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            return
        t = stmt.targets[0]
        if not isinstance(t, ast.Name):
            return
        seg = _ctor_last_segment(stmt.value)
        if seg in _THREAD_CTORS:
            self.local_types[t.id] = "thread"
        elif seg in _QUEUE_CTORS:
            self.local_types[t.id] = "queue"
        elif seg in _LOCK_CTORS:
            self.local_types[t.id] = "rlock" if seg == "RLock" else "lock"
        elif seg in _COND_CTORS:
            self.local_types[t.id] = "cond"
        elif isinstance(stmt.value, ast.Call) \
                and isinstance(stmt.value.func, ast.Attribute) \
                and stmt.value.func.attr == "submit":
            self.local_types[t.id] = "future"

    # -- self-attribute accesses --------------------------------------------
    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
        return None

    def _add_access(self, attr: str, kind: str, lineno: int) -> None:
        if self.ci is None or attr in self.ci.sync_attrs():
            return
        self.scan.accesses.append(_Access(
            attr=attr, kind=kind, lineno=lineno, lockset=self._lockset(),
            method=self.scan.name, stmt_id=self._stmt_counter))

    def _reads_in(self, expr: Optional[ast.AST]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            attr = self._self_attr(node)
            if attr is not None and isinstance(node.ctx, ast.Load):
                self._add_access(attr, "read", node.lineno)

    def _record_accesses(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            value_reads = {self._self_attr(n) for n in ast.walk(stmt.value)
                           if self._self_attr(n) is not None}
            for t in stmt.targets:
                attr = self._self_attr(t)
                if attr is not None:
                    kind = "rmw" if attr in value_reads else "write"
                    self._add_access(attr, kind, t.lineno)
                elif isinstance(t, ast.Subscript):
                    base = self._self_attr(t.value)
                    if base is not None:
                        self._add_access(base, "rmw", t.lineno)
                    self._reads_in(t.value)
                    self._reads_in(t.slice)
                elif isinstance(t, ast.Attribute) \
                        and self._self_attr(t.value) is not None:
                    # `self.state.x = v`: field store into the shared object
                    self._add_access(self._self_attr(t.value), "rmw",
                                     t.lineno)
                else:
                    self._reads_in(t)
            self._reads_in(stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            attr = self._self_attr(stmt.target)
            if attr is not None:
                self._add_access(attr, "rmw", stmt.target.lineno)
            elif isinstance(stmt.target, ast.Subscript):
                base = self._self_attr(stmt.target.value)
                if base is not None:
                    self._add_access(base, "rmw", stmt.target.lineno)
                self._reads_in(stmt.target.slice)
            elif isinstance(stmt.target, ast.Attribute):
                # `self.stats.load_seconds += dt`: an in-place RMW on a
                # field of the object self.stats points to — same hazard
                # granularity as a container mutation on self.stats itself
                base = self._self_attr(stmt.target.value)
                if base is not None:
                    self._add_access(base, "rmw", stmt.target.lineno)
            self._reads_in(stmt.value)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                attr = self._self_attr(t)
                if attr is not None:
                    self._add_access(attr, "write", t.lineno)
                elif isinstance(t, ast.Subscript):
                    base = self._self_attr(t.value)
                    if base is not None:
                        self._add_access(base, "rmw", t.lineno)
        elif isinstance(stmt, (ast.AnnAssign,)):
            attr = self._self_attr(stmt.target)
            if attr is not None and stmt.value is not None:
                self._add_access(attr, "write", stmt.target.lineno)
            self._reads_in(stmt.value)
        else:
            self._reads_in(stmt if isinstance(stmt, ast.expr) else None)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._reads_in_expr_with_mutators(child)

    def _reads_in_expr_with_mutators(self, expr: ast.AST) -> None:
        """Reads inside an expression statement, with ``self.x.append(...)``
        style in-place mutator calls upgraded to RMW accesses."""
        mutated: Set[int] = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATOR_METHODS:
                base = self._self_attr(node.func.value)
                if base is not None:
                    self._add_access(base, "rmw", node.lineno)
                    mutated.add(id(node.func.value))
        for node in ast.walk(expr):
            attr = self._self_attr(node)
            if attr is not None and isinstance(node.ctx, ast.Load) \
                    and id(node) not in mutated:
                self._add_access(attr, "read", node.lineno)

    # -- calls: intra-class, cross-class, blocking ---------------------------
    def _scan_exprs(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._scan_call(sub)

    def _scan_call(self, call: ast.Call) -> None:
        func = call.func
        chain = _attr_chain(func)
        lockset = self._lockset()
        # bound methods passed as arguments register callbacks (thread-model
        # discovery; they may be invoked from another thread later)
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            cb = self._self_attr(arg)
            if cb is not None and self.ci is not None \
                    and cb in self.ci.methods:
                self.scan.callbacks.add(cb)
        if chain is not None and chain.startswith("self.") \
                and self.ci is not None:
            rest = chain[5:]
            if "." not in rest:
                self.scan.self_calls.append((rest, lockset, call.lineno))
            else:
                attr, meth = rest.split(".", 1)
                if "." not in meth:
                    self.scan.attr_calls.append(
                        (attr, meth, lockset, call.lineno))
        self._scan_blocking(call, chain)

    def _kw(self, call: ast.Call, name: str) -> Optional[ast.AST]:
        for kw in call.keywords:
            if kw.arg == name:
                return kw.value
        return None

    def _base_kind(self, base: ast.AST) -> Optional[str]:
        """Resolve a blocking call's receiver to thread/queue/cond/event."""
        attr = self._self_attr(base)
        if attr is not None and self.ci is not None:
            if attr in self.ci.threads:
                return "thread"
            if attr in self.ci.queues:
                return "queue"
            if attr in self.ci.cond_underlying:
                return "cond"
            if attr in self.ci.events:
                return "event"
            name = attr
        elif isinstance(base, ast.Name):
            kind = self.local_types.get(base.id)
            if kind in ("thread", "queue", "cond", "future"):
                return kind
            if base.id in self.mi.cond_underlying:
                return "cond"
            if base.id in self.mi.events:
                return "event"
            name = base.id
        else:
            chain = _attr_chain(base)
            name = chain.rsplit(".", 1)[-1] if chain else ""
        low = name.lower()
        if "queue" in low or low.endswith("_q"):
            return "queue"
        if "thread" in low:
            return "thread"
        if "future" in low or low == "fut":
            return "future"
        return None

    def _cond_lock_token(self, base: ast.AST) -> Optional[str]:
        attr = self._self_attr(base)
        if attr is not None and self.ci is not None \
                and attr in self.ci.cond_underlying:
            return self.ci.canon(attr)
        if isinstance(base, ast.Name) and base.id in self.mi.cond_underlying:
            return self.mi.canon(base.id)
        return None

    def _scan_blocking(self, call: ast.Call, chain: Optional[str]) -> None:
        if not self.held:
            return
        func = call.func
        if not isinstance(func, ast.Attribute):
            return
        name = func.attr
        base = func.value
        desc = None
        releases: FrozenSet[str] = frozenset()
        if name == "join":
            if self._base_kind(base) == "thread":
                desc = "Thread.join()"
        elif name in ("get", "put"):
            if self._base_kind(base) == "queue":
                blk = self._kw(call, "block")
                if not (isinstance(blk, ast.Constant) and blk.value is False):
                    desc = f"Queue.{name}() (blocking form)"
        elif name == "result":
            # `.result()` under a lock is near-always a concurrent.futures
            # wait; false positives get an inline allow marker
            desc = "future.result()"
        elif name in ("wait", "wait_for"):
            kind = self._base_kind(base)
            if kind == "cond":
                own = self._cond_lock_token(base)
                releases = frozenset({own} if own else ())
                desc = f"Condition.{name}() on {own or 'its lock'}"
            elif kind == "event":
                desc = "Event.wait()"
        elif name in _DEVICE_SYNC_ATTRS:
            desc = f"{name}() device sync"
        elif chain == "time.sleep":
            desc = "time.sleep()"
        if desc is None:
            return
        # waiting on a condition releases ONLY its own lock; holding any
        # OTHER lock across the wait starves every path needing it
        still_held = tuple((t, ln) for t, ln in self.held
                           if t not in releases)
        if not still_held:
            return
        self.scan.blocking.append(_Blocking(
            desc=desc, lineno=call.lineno, held=still_held,
            releases=releases))
        if name in ("wait", "wait_for"):
            tok = self._cond_lock_token(base)
            if tok:
                self.scan.waits_on.add(tok)


# ---------------------------------------------------------------------------
# file-level discovery: classes, locks, threads
# ---------------------------------------------------------------------------

def _scan_class(node: ast.ClassDef, filename: str, module: str) -> _ClassInfo:
    ci = _ClassInfo(name=node.name, filename=filename, module=module,
                    lineno=node.lineno)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ci.methods[item.name] = item
    for meth_name, meth in ci.methods.items():
        for sub in ast.walk(meth):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                t = sub.targets[0]
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    attr = t.attr
                    if meth_name == "__init__":
                        ci.init_written.add(attr)
                    for cand in _iter_ctor_candidates(sub.value):
                        seg = _ctor_last_segment(cand)
                        if seg in _LOCK_CTORS:
                            ci.locks[attr] = \
                                "rlock" if seg == "RLock" else "lock"
                        elif seg in _SEM_CTORS:
                            ci.locks[attr] = "lock"
                        elif seg in _COND_CTORS:
                            under = attr
                            if cand.args:
                                a0 = cand.args[0]
                                if isinstance(a0, ast.Attribute) \
                                        and isinstance(a0.value, ast.Name) \
                                        and a0.value.id == "self":
                                    under = a0.attr
                            ci.cond_underlying[attr] = under
                            if under == attr:
                                ci.locks.setdefault(attr, "lock")
                        elif seg in _EVENT_CTORS:
                            ci.events.add(attr)
                        elif seg in _QUEUE_CTORS:
                            ci.queues.add(attr)
                        elif seg in _THREAD_CTORS:
                            ci.threads.add(attr)
                        elif seg is not None and seg[:1].isupper():
                            ci.attr_types.setdefault(attr, seg)
            if isinstance(sub, ast.Call) \
                    and _ctor_last_segment(sub) in _THREAD_CTORS:
                for kw in sub.keywords:
                    if kw.arg == "target" and isinstance(kw.value,
                                                         ast.Attribute) \
                            and isinstance(kw.value.value, ast.Name) \
                            and kw.value.value.id == "self":
                        ci.thread_targets.add(kw.value.attr)
                        ci.thread_sites.append((kw.value.attr, sub.lineno))
    return ci


def _scan_module(tree: ast.Module, filename: str, module: str) -> _ModuleInfo:
    mi = _ModuleInfo(module=module, filename=filename)
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            seg = _ctor_last_segment(node.value)
            if seg in _LOCK_CTORS or seg in _SEM_CTORS:
                mi.locks[name] = "rlock" if seg == "RLock" else "lock"
            elif seg in _COND_CTORS:
                under = name
                if isinstance(node.value, ast.Call) and node.value.args:
                    a0 = node.value.args[0]
                    if isinstance(a0, ast.Name):
                        under = a0.id
                mi.cond_underlying[name] = under
                if under == name:
                    mi.locks.setdefault(name, "lock")
            elif seg in _EVENT_CTORS:
                mi.events.add(name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _ctor_last_segment(node) in _THREAD_CTORS:
            for kw in node.keywords:
                if kw.arg == "target" and isinstance(kw.value, ast.Name):
                    mi.thread_targets.add(kw.value.id)
    return mi


# ---------------------------------------------------------------------------
# class-level lockset analysis (TM311 / TM312 / TM314)
# ---------------------------------------------------------------------------

def _entry_locksets(ci: _ClassInfo,
                    scans: Dict[str, _MethodScan]) -> Dict[str, FrozenSet[str]]:
    """Lockset a method's CALLER holds on entry.

    ``*_locked``-suffixed names hold the class's primary lock by convention;
    otherwise a private method whose every intra-class call site holds a
    common lock inherits that intersection (3-round fixpoint — the call
    graphs here are shallow)."""
    entry: Dict[str, FrozenSet[str]] = {m: frozenset() for m in scans}
    primary = ci.primary_lock()
    for m in scans:
        if m.endswith("_locked") and primary is not None:
            entry[m] = frozenset({ci.canon(primary)})
    for _ in range(3):
        for m, scan0 in scans.items():
            if m.endswith("_locked") or not m.startswith("_") \
                    or m.startswith("__") or m in ci.thread_targets:
                continue
            sites: List[FrozenSet[str]] = []
            for caller, cscan in scans.items():
                for callee, lockset, _ln in cscan.self_calls:
                    if callee == m:
                        sites.append(lockset | entry[caller])
            if sites:
                common = frozenset.intersection(*sites)
                if common:
                    entry[m] = common
    return entry


def _method_sides(ci: _ClassInfo,
                  scans: Dict[str, _MethodScan]) -> Dict[str, Set[str]]:
    """Which thread(s) can run each method: 'thread' (the class's own
    background worker), 'main' (any external caller), or both."""
    callees: Dict[str, Set[str]] = {
        m: {c for c, _ls, _ln in s.self_calls if c in scans}
        for m, s in scans.items()}
    sides: Dict[str, Set[str]] = {m: set() for m in scans}

    def flood(roots: Set[str], tag: str) -> None:
        frontier = [r for r in roots if r in scans]
        seen: Set[str] = set()
        while frontier:
            m = frontier.pop()
            if m in seen:
                continue
            seen.add(m)
            sides[m].add(tag)
            frontier.extend(callees[m])

    flood(set(ci.thread_targets), "thread")
    public = {m for m in scans
              if (not m.startswith("_")) and m not in ci.thread_targets}
    flood(public, "main")
    for m in scans:   # private helpers nobody calls intra-class: external
        if not sides[m] and m != "__init__":
            sides[m].add("main")
    return sides


def _fmt_locks(tokens) -> str:
    return "/".join(sorted(tokens)) or "<none>"


def _init_closure(scans: Dict[str, _MethodScan]) -> Set[str]:
    """``__init__`` plus the private helpers called ONLY from it.

    Fixpoint: a private method joins the closure when it has at least one
    intra-class call site and every such site is in a method already in the
    closure.  Public methods never join (callable externally after
    construction), and a private helper with no intra-class call sites stays
    out too (it may be an external-protocol hook, e.g. a thread target)."""
    if "__init__" not in scans:
        return set()
    callers: Dict[str, Set[str]] = {m: set() for m in scans}
    for m, s in scans.items():
        for c, _ls, _ln in s.self_calls:
            if c in callers:
                callers[c].add(m)
    closure: Set[str] = {"__init__"}
    changed = True
    while changed:
        changed = False
        for m in scans:
            if m in closure or not m.startswith("_") or m.startswith("__"):
                continue
            if callers[m] and callers[m] <= closure:
                closure.add(m)
                changed = True
    return closure


def _class_attr_findings(ci: _ClassInfo, scans: Dict[str, _MethodScan],
                         entry: Dict[str, FrozenSet[str]]
                         ) -> List[LintFinding]:
    declared_concurrent = bool(ci.locks or ci.cond_underlying)
    if not ci.thread_targets and not declared_concurrent:
        return []
    if ci.thread_targets:
        sides = _method_sides(ci, scans)
        who = (f"the {ci.name} background thread "
               f"({'/'.join(sorted(ci.thread_targets))}) and external "
               f"callers")
    else:
        # RacerD's declared-concurrency assumption: a class that constructs
        # its own lock announces multi-threaded use — every method is
        # potentially concurrent (serving handlers, console pollers, the
        # batcher flusher reaching in), so all sides are 'both'
        sides = {m: {"thread", "main"} for m in scans}
        who = f"concurrent callers of the lock-owning class {ci.name}"
    qual = {m: s.qualname for m, s in scans.items()}

    # gather per-attr accesses with entry locksets folded in; __init__ AND
    # helpers reachable ONLY from __init__ are excluded — construction
    # happens-before any second thread can hold a reference
    init_only = _init_closure(scans)
    by_attr: Dict[str, List[_Access]] = {}
    for m, scan in scans.items():
        if m in init_only:
            continue
        for a in scan.accesses:
            eff = _Access(attr=a.attr, kind=a.kind, lineno=a.lineno,
                          lockset=a.lockset | entry[m], method=m,
                          stmt_id=a.stmt_id)
            by_attr.setdefault(a.attr, []).append(eff)

    shared: Dict[str, List[_Access]] = {}
    for attr, accs in by_attr.items():
        tags = set()
        for a in accs:
            tags |= sides.get(a.method, set())
        writes = [a for a in accs if a.kind in ("write", "rmw")]
        if not ({"thread", "main"} <= tags and writes):
            continue
        if not ci.thread_targets and len({a.method for a in accs}) < 2:
            # declared-concurrent mode has no proven second thread: an
            # attr touched by a single method is weak sharing evidence
            continue
        shared[attr] = accs

    out: List[LintFinding] = []
    write_guard: Dict[str, FrozenSet[str]] = {}
    for attr, accs in sorted(shared.items()):
        writes = [a for a in accs if a.kind in ("write", "rmw")]
        all_guard = frozenset.intersection(*(a.lockset for a in accs))
        if all_guard:
            continue     # consistently guarded everywhere
        wguard = frozenset.intersection(*(a.lockset for a in writes))
        write_guard[attr] = wguard
        if wguard:
            continue     # reads handled below (TM311/TM314 need grouping)
        locked_sites = [a for a in accs if a.lockset]
        for a in writes:
            if a.lockset:
                continue
            if a.kind == "rmw":
                out.append(LintFinding(
                    code="TM312",
                    message=(
                        f"unlocked read-modify-write of shared attribute "
                        f"self.{attr} at line {a.lineno}: {who} touch it "
                        f"with no common lock; the increment/in-place "
                        f"mutation loses updates"),
                    qualname=qual[a.method], filename=ci.filename,
                    lineno=a.lineno))
            elif locked_sites:
                o = locked_sites[0]
                out.append(LintFinding(
                    code="TM311",
                    message=(
                        f"inconsistent lockset on shared attribute "
                        f"self.{attr}: written with no lock at line "
                        f"{a.lineno}, but accessed under "
                        f"{_fmt_locks(o.lockset)} at line {o.lineno}"),
                    qualname=qual[a.method], filename=ci.filename,
                    lineno=a.lineno))

    # TM311 / TM314 for attrs whose writes ARE disciplined: offending reads
    torn_stmts: Set[Tuple[str, int]] = set()
    for attr, accs in sorted(shared.items()):
        wguard = write_guard.get(attr, frozenset())
        if not wguard:
            continue
        writes = [a for a in accs if a.kind in ("write", "rmw")]
        wexample = writes[0]
        offending = [a for a in accs if a.kind == "read"
                     and not (a.lockset & wguard)]
        # TM314: one statement reading >=2 guarded attrs without the guard
        for a in offending:
            key = (a.method, a.stmt_id)
            if key in torn_stmts:
                continue
            stmt_attrs = {
                b.attr
                for other, oaccs in shared.items()
                for b in oaccs
                if b.kind == "read" and (b.method, b.stmt_id) == key
                and write_guard.get(other) and not (b.lockset
                                                    & write_guard[other])}
            if len(stmt_attrs) >= 2:
                torn_stmts.add(key)
                out.append(LintFinding(
                    code="TM314",
                    message=(
                        f"unguarded multi-field read of "
                        f"{', '.join('self.' + x for x in sorted(stmt_attrs))}"
                        f" at line {a.lineno} can observe torn state: "
                        f"writers update them under "
                        f"{_fmt_locks(wguard)} (e.g. line "
                        f"{wexample.lineno})"),
                    qualname=qual[a.method], filename=ci.filename,
                    lineno=a.lineno))
        seen_lines: Set[int] = set()
        for a in offending:
            if (a.method, a.stmt_id) in torn_stmts or a.lineno in seen_lines:
                continue
            seen_lines.add(a.lineno)
            out.append(LintFinding(
                code="TM311",
                message=(
                    f"inconsistent lockset on shared attribute self.{attr}: "
                    f"read at line {a.lineno} without its guard "
                    f"{_fmt_locks(wguard)}; every write holds it "
                    f"(e.g. line {wexample.lineno})"),
                qualname=qual[a.method], filename=ci.filename,
                lineno=a.lineno))
    return out


# ---------------------------------------------------------------------------
# lock-order graph (TM313) + blocking-under-lock (TM315)
# ---------------------------------------------------------------------------

def _acquire_closures(scans: Dict[str, _MethodScan],
                      entry: Dict[str, FrozenSet[str]]
                      ) -> Dict[str, Set[str]]:
    """Locks each method may acquire, directly or via intra-class calls."""
    direct = {m: {tok for tok, _held, _ln in s.acquires}
              for m, s in scans.items()}
    closure = {m: set(v) for m, v in direct.items()}
    for _ in range(4):
        changed = False
        for m, s in scans.items():
            for callee, _ls, _ln in s.self_calls:
                if callee in closure and not (closure[callee]
                                              <= closure[m]):
                    closure[m] |= closure[callee]
                    changed = True
        if not changed:
            break
    return closure


def _collect_edges(ci: Optional[_ClassInfo], scans: Dict[str, _MethodScan],
                   entry: Dict[str, FrozenSet[str]],
                   classes: Dict[str, "_ClassScan"],
                   filename: str) -> List[LockEdge]:
    closures = _acquire_closures(scans, entry)
    edges: List[LockEdge] = []

    def add(outer: str, inner: str, lineno: int, qualname: str) -> None:
        edges.append(LockEdge(outer=outer, inner=inner, filename=filename,
                              lineno=lineno, qualname=qualname))

    for m, scan in scans.items():
        ent = entry.get(m, frozenset())
        for tok, held, lineno in scan.acquires:
            for outer in set(t for t, _ in held) | ent:
                add(outer, tok, lineno, scan.qualname)
        for callee, lockset, lineno in scan.self_calls:
            if callee not in closures:
                continue
            for outer in lockset | ent:
                for inner in closures[callee]:
                    add(outer, inner, lineno, scan.qualname)
        if ci is not None:
            for attr, meth, lockset, lineno in scan.attr_calls:
                tcls = ci.attr_types.get(attr)
                target = classes.get(tcls) if tcls else None
                if target is None:
                    continue
                inner_toks = target.closures.get(meth, set()) \
                    | set(target.entry.get(meth, frozenset()))
                for outer in lockset | ent:
                    for inner in inner_toks:
                        add(outer, inner, lineno, scan.qualname)
    return edges


def _blocking_findings(scans: Dict[str, _MethodScan],
                       entry: Dict[str, FrozenSet[str]],
                       filename: str) -> List[LintFinding]:
    out: List[LintFinding] = []
    for m, scan in scans.items():
        ent = entry.get(m, frozenset())
        for b in scan.blocking:
            held = list(b.held) + [(t, scan.lineno) for t in ent
                                   if t not in {x for x, _ in b.held}
                                   and t not in b.releases]
            if not held:
                continue
            locks = ", ".join(f"{t} (acquired line {ln})"
                              for t, ln in sorted(held))
            out.append(LintFinding(
                code="TM315",
                message=(
                    f"blocking call {b.desc} at line {b.lineno} while "
                    f"holding {locks}: every thread needing the lock stalls "
                    f"behind the wait (deadlock-prone if the waited-for "
                    f"work needs it)"),
                qualname=scan.qualname, filename=filename,
                lineno=b.lineno))
    return out


def _lock_kinds(class_scans: Dict[str, "_ClassScan"],
                modules: List[_ModuleInfo]) -> Dict[str, str]:
    kinds: Dict[str, str] = {}
    for cs in class_scans.values():
        for attr, kind in cs.ci.locks.items():
            kinds[cs.ci.canon(attr)] = kind
    for mi in modules:
        for name, kind in mi.locks.items():
            kinds[mi.canon(name)] = kind
    return kinds


def _cycle_findings(edges: List[LockEdge],
                    kinds: Dict[str, str]) -> List[LintFinding]:
    graph: Dict[str, Dict[str, LockEdge]] = {}
    for e in edges:
        if e.outer == e.inner:
            continue   # self-edges handled separately below
        graph.setdefault(e.outer, {}).setdefault(e.inner, e)
    out: List[LintFinding] = []
    reported: Set[Tuple[str, ...]] = set()

    # self-deadlock: re-acquiring a held non-reentrant lock
    seen_self: Set[Tuple[str, int]] = set()
    for e in edges:
        if e.outer != e.inner or kinds.get(e.outer) == "rlock":
            continue
        key = (e.filename, e.lineno)
        if key in seen_self:
            continue
        seen_self.add(key)
        out.append(LintFinding(
            code="TM313",
            message=(
                f"lock {e.outer} re-acquired while already held at "
                f"{e.filename}:{e.lineno} — a non-reentrant Lock "
                f"self-deadlocks here"),
            qualname=e.qualname, filename=e.filename, lineno=e.lineno))

    def dfs(start: str) -> Optional[List[LockEdge]]:
        stack: List[Tuple[str, List[LockEdge]]] = [(start, [])]
        visited: Set[str] = set()
        while stack:
            node, path = stack.pop()
            for nxt, edge in sorted(graph.get(node, {}).items()):
                if nxt == start:
                    return path + [edge]
                if nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, path + [edge]))
        return None

    for start in sorted(graph):
        cyc = dfs(start)
        if not cyc:
            continue
        nodes = tuple(sorted({e.outer for e in cyc} | {e.inner for e in cyc}))
        if nodes in reported:
            continue
        reported.add(nodes)
        path = " -> ".join([cyc[0].outer] + [e.inner for e in cyc])
        sites = "; ".join(
            f"{e.inner} acquired while holding {e.outer} at "
            f"{os.path.basename(e.filename)}:{e.lineno}" for e in cyc)
        first = cyc[0]
        out.append(LintFinding(
            code="TM313",
            message=(f"lock-order cycle {path} (potential deadlock): "
                     f"{sites}"),
            qualname=first.qualname, filename=first.filename,
            lineno=first.lineno))
    return out


# ---------------------------------------------------------------------------
# module-global lockset rule — the TM306 engine (opcheck delegates here)
# ---------------------------------------------------------------------------

class _ModuleGlobalLinter(ast.NodeVisitor):
    """Read-modify-writes of module-level mutables outside any ``with
    <lock>:`` frame — the engine behind opcheck's TM306 rule."""

    def __init__(self, mutables: Set[str], qualname: str, filename: str,
                 lines: List[str]):
        self.mutables = mutables
        self.qualname = qualname
        self.filename = filename
        self.lines = lines
        self.lock_depth = 0
        self.findings: List[LintFinding] = []

    def _flag(self, node: ast.AST, name: str, how: str) -> None:
        if self.lock_depth > 0:
            return
        f = LintFinding(
            code="TM306",
            message=f"module-level mutable {name!r} {how} outside a "
                    "threading lock; concurrent callers race on it",
            qualname=self.qualname, filename=self.filename,
            lineno=getattr(node, "lineno", 0))
        lineno = f.lineno
        if 0 < lineno <= len(self.lines):
            m = _ALLOW_RE.search(self.lines[lineno - 1])
            if m and "TM306" in m.group(1):
                return
        self.findings.append(f)

    def visit_With(self, node: ast.With) -> None:
        locky = any(_looks_like_lock(item.context_expr)
                    for item in node.items)
        if locky:
            self.lock_depth += 1
        self.generic_visit(node)
        if locky:
            self.lock_depth -= 1

    visit_AsyncWith = visit_With

    def _target_mutable(self, target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Subscript) \
                and isinstance(target.value, ast.Name) \
                and target.value.id in self.mutables:
            return target.value.id
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            name = self._target_mutable(t)
            if name:
                self._flag(node, name, "item-assigned")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        name = self._target_mutable(node.target)
        # `_CACHE |= d` / `_CACHE += [...]` on the bare name mutates the
        # container in place — the same race as `.update()`/`.extend()`
        if name is None and isinstance(node.target, ast.Name) \
                and node.target.id in self.mutables:
            name = node.target.id
        if name:
            self._flag(node, name, "augmented-assigned")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            name = self._target_mutable(t)
            if name:
                self._flag(node, name, "item-deleted")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) \
                and func.attr in _MUTATOR_METHODS \
                and isinstance(func.value, ast.Name) \
                and func.value.id in self.mutables:
            self._flag(node, func.value.id, f"mutated via .{func.attr}()")
        self.generic_visit(node)


def module_global_findings(source: str, filename: str = "<string>",
                           tree: Optional[ast.AST] = None
                           ) -> List[LintFinding]:
    """TM306 engine: module-level mutable containers mutated inside function
    bodies outside a ``with <lock>:`` frame.  Behavior-identical to the
    historical opcheck rule — opcheck's :func:`lint_module_concurrency`
    delegates here so the two rules share one lock-scope tracker."""
    if tree is None:
        tree = ast.parse(source, filename=filename)
    lines = source.splitlines()
    mutables: Set[str] = set()
    for node in tree.body:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if _is_mutable_ctor(value):
            for t in targets:
                if isinstance(t, ast.Name):
                    mutables.add(t.id)
    if not mutables:
        return []
    out: List[LintFinding] = []
    for qualname, fn in _iter_functions(tree):
        linter = _ModuleGlobalLinter(mutables, qualname, filename, lines)
        for stmt in fn.body:
            linter.visit(stmt)
        out.extend(linter.findings)
    return out


# ---------------------------------------------------------------------------
# whole-program driver
# ---------------------------------------------------------------------------

@dataclass
class _ClassScan:
    ci: _ClassInfo
    scans: Dict[str, _MethodScan]
    entry: Dict[str, FrozenSet[str]]
    closures: Dict[str, Set[str]] = field(default_factory=dict)


@dataclass
class _FileScan:
    filename: str
    lines: List[str]
    mi: _ModuleInfo
    classes: List[_ClassScan]
    module_fns: Dict[str, _MethodScan]


def _scan_file(source: str, filename: str,
               tree: Optional[ast.AST] = None) -> _FileScan:
    if tree is None:
        tree = ast.parse(source, filename=filename)
    module = os.path.splitext(os.path.basename(filename))[0]
    mi = _scan_module(tree, filename, module)
    classes: List[_ClassScan] = []
    module_fns: Dict[str, _MethodScan] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            ci = _scan_class(node, filename, module)
            scans = {
                name: _MethodAnalyzer(fn, f"{ci.name}.{name}", ci, mi).run()
                for name, fn in ci.methods.items()}
            entry = _entry_locksets(ci, scans)
            cs = _ClassScan(ci=ci, scans=scans, entry=entry)
            cs.closures = _acquire_closures(scans, entry)
            classes.append(cs)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_fns[node.name] = _MethodAnalyzer(
                node, node.name, None, mi).run()
    return _FileScan(filename=filename, lines=source.splitlines(), mi=mi,
                     classes=classes, module_fns=module_fns)


def _suppress(findings: List[LintFinding],
              lines_by_file: Dict[str, List[str]]) -> List[LintFinding]:
    out = []
    for f in findings:
        lines = lines_by_file.get(f.filename, [])
        if 0 < f.lineno <= len(lines):
            m = _ALLOW_RE.search(lines[f.lineno - 1])
            if m and f.code in m.group(1):
                continue
        out.append(f)
    return out


def _analyze(file_scans: List[_FileScan]) -> ThreadAnalysis:
    class_reg: Dict[str, _ClassScan] = {}
    for fs in file_scans:
        for cs in fs.classes:
            class_reg.setdefault(cs.ci.name, cs)

    findings: List[LintFinding] = []
    edges: List[LockEdge] = []
    model = ThreadModel(analyzed_files=len(file_scans))

    for fs in file_scans:
        for cs in fs.classes:
            ci = cs.ci
            findings.extend(_class_attr_findings(ci, cs.scans, cs.entry))
            findings.extend(_blocking_findings(cs.scans, cs.entry,
                                               fs.filename))
            edges.extend(_collect_edges(ci, cs.scans, cs.entry, class_reg,
                                        fs.filename))
            for target, lineno in ci.thread_sites:
                model.threads.append({
                    "target": f"{ci.name}.{target}",
                    "file": os.path.basename(fs.filename), "line": lineno})
            if ci.thread_targets:
                model.shared_classes.append(ci.name)
            for m, scan in cs.scans.items():
                if scan.waits_on:
                    model.waiters.append(scan.qualname)
                for cb in scan.callbacks:
                    model.callbacks.append(f"{ci.name}.{cb}")
        if fs.module_fns:
            entry = {m: frozenset() for m in fs.module_fns}
            findings.extend(_blocking_findings(fs.module_fns, entry,
                                               fs.filename))
            edges.extend(_collect_edges(None, fs.module_fns, entry,
                                        class_reg, fs.filename))
        for fn_name in fs.mi.thread_targets:
            if fn_name in fs.module_fns:
                model.threads.append({
                    "target": fn_name,
                    "file": os.path.basename(fs.filename),
                    "line": fs.module_fns[fn_name].lineno})

    kinds = _lock_kinds(class_reg, [fs.mi for fs in file_scans])
    findings.extend(_cycle_findings(edges, kinds))

    seen_edges: Set[Tuple[str, str]] = set()
    for e in edges:
        if e.outer != e.inner and (e.outer, e.inner) not in seen_edges:
            seen_edges.add((e.outer, e.inner))
            model.lock_order_edges.append(e)

    lines_by_file = {fs.filename: fs.lines for fs in file_scans}
    findings = _suppress(findings, lines_by_file)
    findings.sort(key=lambda f: (f.filename, f.lineno, f.code))
    return ThreadAnalysis(findings=findings, model=model)


def analyze_source(source: str, filename: str = "<string>",
                   tree: Optional[ast.AST] = None) -> ThreadAnalysis:
    """Analyze one source string (fixtures, single modules)."""
    return _analyze([_scan_file(source, filename, tree=tree)])


def analyze_files(paths: Sequence[str]) -> ThreadAnalysis:
    """Whole-program analysis over a file set: per-file lockset inference
    plus ONE merged lock-order graph (TM313 cycles can span modules)."""
    scans: List[_FileScan] = []
    for path in paths:
        with open(path) as fh:
            source = fh.read()
        scans.append(_scan_file(source, path))
    return _analyze(scans)


def analyze_parsed(items: Sequence[Tuple[str, str, ast.AST]]
                   ) -> ThreadAnalysis:
    """Whole-program analysis over ``(source, filename, tree)`` triples —
    the CLI's parse-once path (``cli lint --threads`` shares each file's
    tree with the TM3xx lint instead of re-parsing)."""
    return _analyze([_scan_file(src, fname, tree=tree)
                     for src, fname, tree in items])
