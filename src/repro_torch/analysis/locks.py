"""Lock-discipline sanitizer for the concurrent layer (serving/ + obs/).

A lightweight intra-procedural checker over classes that own
``threading.Lock``/``RLock``/``Condition`` attributes.  Three rules share one
walk per file:

``lock-mutation``
    An attribute the class elsewhere mutates *under* a lock is mutated on a
    path that holds no lock.  "Shared" is inferred, not declared: if any
    method writes ``self._queue`` inside ``with self._cond:``, every other
    write to ``self._queue`` must hold a lock too (or carry a reasoned
    suppression).  Methods whose name ends in ``_locked`` are exempt — that
    suffix is the repo convention for "caller holds the lock".

``lock-order``
    Two locks of the same class are acquired in both nestings somewhere in
    the file — the classic ABBA deadlock shape.

``lock-blocking``
    A blocking call (socket I/O, ``sleep``, future results, oracle
    ``predict*``/``measure*`` work) executes while a lock is held, stalling
    every thread that contends on it.  ``.wait()`` on a *held* Condition is
    exempt (it releases the lock while waiting — that is the point of it).

The walker is deliberately syntactic: it tracks ``with self._lock:`` blocks
(including multi-item ``with`` and nesting through if/for/while/try), not
``acquire()``/``release()`` call pairs, because that is the only idiom this
codebase uses.  Nested functions are walked with an *empty* held-set — a
closure created under a lock generally runs later without it, which is
exactly the deferred-callback hazard worth flagging.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator

from repro_torch.analysis.engine import (
    FileContext,
    Finding,
    Rule,
    call_name,
    dotted_name,
    register,
)

#: constructor names that make a ``self.X = threading.<ctor>()`` a lock attr
_LOCK_CTORS = frozenset(
    {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
)

#: container-mutating method names (write/flush/read/close excluded on
#: purpose: the tracer appends to its file under its own single-writer
#: protocol, and flagging every file op would drown the real races)
_MUTATORS = frozenset(
    {
        "append", "add", "update", "setdefault", "pop", "popitem", "remove",
        "discard", "clear", "extend", "insert", "move_to_end", "appendleft",
        "sort", "put",
    }
)

#: call terminal names that block the calling thread
_BLOCKING = frozenset(
    {
        "sleep", "recv", "send", "sendall", "accept", "connect",
        "create_connection", "readline", "result", "wait",
        "predict", "predict_many", "predict_networks",
        "measure", "measure_batch", "measure_block_batch",
        "process", "load",
    }
)

#: methods never analyzed for mutation/blocking (setup/teardown run before
#: or after any concurrent access exists)
_EXEMPT_METHODS = frozenset({"__init__", "__new__", "__del__", "__repr__"})


@dataclasses.dataclass
class _Mutation:
    attr: str
    node: ast.AST
    held: frozenset[str]
    method: str


@dataclasses.dataclass
class _Blocking:
    label: str
    node: ast.AST
    held: frozenset[str]
    method: str


@dataclasses.dataclass
class _Acquisition:
    """Lock ``inner`` acquired while ``outer`` already held."""

    outer: str
    inner: str
    node: ast.AST
    method: str


@dataclasses.dataclass
class _ClassAnalysis:
    name: str
    locks: frozenset[str]
    mutations: list[_Mutation]
    blocking: list[_Blocking]
    acquisitions: list[_Acquisition]


def _self_attr(expr: ast.AST) -> str | None:
    """``self.X`` -> ``X`` (only one level deep)."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> frozenset[str]:
    out = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        ctor = (call_name(node.value) or "").split(".")[-1]
        if ctor not in _LOCK_CTORS:
            continue
        for target in node.targets:
            attr = _self_attr(target)
            if attr is not None:
                out.add(attr)
    return frozenset(out)


class _MethodWalker:
    """Held-lock-set walk of one method body."""

    def __init__(self, analysis: _ClassAnalysis, method: str) -> None:
        self.a = analysis
        self.method = method

    def _lock_of(self, expr: ast.expr) -> str | None:
        """``with self._lock:`` / ``with self._cond:`` -> the lock attr."""
        attr = _self_attr(expr)
        if attr is not None and attr in self.a.locks:
            return attr
        return None

    # -- statement dispatch -----------------------------------------------
    def walk(self, stmts: Iterable[ast.stmt], held: frozenset[str]) -> None:
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, stmt: ast.stmt, held: frozenset[str]) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                lock = self._lock_of(item.context_expr)
                if lock is None:
                    self._expr(item.context_expr, new_held)
                else:
                    for outer in sorted(new_held):
                        self.a.acquisitions.append(
                            _Acquisition(outer, lock, item.context_expr,
                                         self.method)
                        )
                    new_held = new_held | {lock}
            self.walk(stmt.body, new_held)
        elif isinstance(stmt, ast.If):
            self._expr(stmt.test, held)
            self.walk(stmt.body, held)
            self.walk(stmt.orelse, held)
        elif isinstance(stmt, (ast.While,)):
            self._expr(stmt.test, held)
            self.walk(stmt.body, held)
            self.walk(stmt.orelse, held)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, held)
            self._mutation_targets(stmt.target, held)
            self.walk(stmt.body, held)
            self.walk(stmt.orelse, held)
        elif isinstance(stmt, ast.Try):
            self.walk(stmt.body, held)
            for handler in stmt.handlers:
                self.walk(handler.body, held)
            self.walk(stmt.orelse, held)
            self.walk(stmt.finalbody, held)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A closure defined here usually runs later, lock-free.
            self.walk(stmt.body, frozenset())
        elif isinstance(stmt, ast.ClassDef):
            pass  # nested classes: out of scope
        else:
            self._simple(stmt, held)

    # -- simple statements -------------------------------------------------
    def _simple(self, stmt: ast.stmt, held: frozenset[str]) -> None:
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                self._mutation_targets(target, held)
            self._expr(stmt.value, held)
        elif isinstance(stmt, ast.AugAssign):
            self._mutation_targets(stmt.target, held)
            self._expr(stmt.value, held)
        elif isinstance(stmt, ast.AnnAssign):
            self._mutation_targets(stmt.target, held)
            if stmt.value is not None:
                self._expr(stmt.value, held)
        elif isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                self._mutation_targets(target, held)
        else:
            for expr in ast.iter_child_nodes(stmt):
                if isinstance(expr, ast.expr):
                    self._expr(expr, held)

    def _mutation_targets(self, target: ast.expr, held: frozenset[str]) -> None:
        """Record attribute / container-slot writes rooted at ``self``."""
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._mutation_targets(elt, held)
            return
        root = target
        while isinstance(root, (ast.Subscript, ast.Starred)):
            root = root.value
        attr = _self_attr(root)
        if attr is not None and attr not in self.a.locks:
            self.a.mutations.append(_Mutation(attr, target, held, self.method))
        if isinstance(target, ast.Subscript):
            self._expr(target.slice, held)

    # -- expressions -------------------------------------------------------
    def _expr(self, expr: ast.expr, held: frozenset[str]) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            self._call(node, held)

    def _call(self, node: ast.Call, held: frozenset[str]) -> None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        terminal = func.attr
        recv_attr = _self_attr(func.value)
        # container mutators on self.<attr>
        if terminal in _MUTATORS and recv_attr is not None:
            if recv_attr not in self.a.locks:
                self.a.mutations.append(
                    _Mutation(recv_attr, node, held, self.method)
                )
        # blocking calls while holding a lock
        if terminal in _BLOCKING and held:
            if terminal == "wait" and recv_attr in held:
                return  # Condition.wait releases the held lock
            if isinstance(func.value, ast.Constant):
                return  # "sep".join-style string-method false positives
            label = dotted_name(func) or terminal
            self.a.blocking.append(_Blocking(label, node, held, self.method))


def _analyze_class(cls: ast.ClassDef) -> _ClassAnalysis | None:
    locks = _lock_attrs(cls)
    if not locks:
        return None
    analysis = _ClassAnalysis(cls.name, locks, [], [], [])
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in _EXEMPT_METHODS or node.name.endswith("_locked"):
            continue
        _MethodWalker(analysis, node.name).walk(node.body, frozenset())
    return analysis


def _analyses(ctx: FileContext) -> list[_ClassAnalysis]:
    cached = getattr(ctx, "_pr_lock_analyses", None)
    if cached is None:
        cached = [
            a
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.ClassDef)
            and (a := _analyze_class(node)) is not None
        ]
        ctx._pr_lock_analyses = cached  # type: ignore[attr-defined]
    return cached


LOCK_SCOPE = (
    "repro_torch.serving",
    "repro_torch.obs.metrics",
    "repro_torch.obs.trace",
    "repro_torch.runtime.faults",
    "repro_torch.runtime.health",
)


@register
class LockMutation(Rule):
    """PR 6/8: every shared-state write in the serving layer holds its lock.

    The server coalesces concurrent requests, so its queues, caches and
    registries are touched from many threads; a single unlocked write is a
    data race today and a corrupted merge tomorrow.
    """

    name = "lock-mutation"
    description = (
        "attributes the class mutates under a lock must never be mutated "
        "lock-free (suffix a method `_locked` if its caller holds the lock)"
    )
    scope = LOCK_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for analysis in _analyses(ctx):
            shared = {
                m.attr for m in analysis.mutations if m.held
            }
            for m in analysis.mutations:
                if m.held or m.attr not in shared:
                    continue
                yield ctx.finding(
                    self.name, m.node,
                    f"{analysis.name}.{m.method} mutates self.{m.attr} "
                    "without holding a lock, but other methods mutate it "
                    "under one — either take the lock or rename the method "
                    "with a `_locked` suffix if the caller already holds it",
                )


@register
class LockOrder(Rule):
    """Locks of one class must nest in a single global order (no ABBA)."""

    name = "lock-order"
    description = "no lock-acquisition order inversions within a class"
    scope = LOCK_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for analysis in _analyses(ctx):
            orders: dict[tuple[str, str], _Acquisition] = {}
            for acq in analysis.acquisitions:
                orders.setdefault((acq.outer, acq.inner), acq)
            for (outer, inner), acq in sorted(orders.items()):
                if (inner, outer) in orders and outer < inner:
                    other = orders[(inner, outer)]
                    yield ctx.finding(
                        self.name, acq.node,
                        f"{analysis.name} acquires self.{inner} while holding "
                        f"self.{outer} here, but {other.method} nests them "
                        "the other way round — an ABBA deadlock waiting for "
                        "contention; pick one global order",
                    )


@register
class LockBlocking(Rule):
    """No socket I/O, sleeps or oracle work while holding a lock.

    A blocking call under a lock turns one slow request into a stall for
    every thread contending on that lock — the serving layer's latency
    metrics exist precisely to keep p99 honest.
    """

    name = "lock-blocking"
    description = (
        "blocking calls (I/O, sleep, predict/measure, future results) must "
        "not run while a lock is held"
    )
    scope = LOCK_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for analysis in _analyses(ctx):
            for b in analysis.blocking:
                locks = ", ".join(f"self.{h}" for h in sorted(b.held))
                yield ctx.finding(
                    self.name, b.node,
                    f"{analysis.name}.{b.method} calls {b.label}() while "
                    f"holding {locks}; every contending thread stalls for "
                    "the full call — move it outside the critical section",
                )
