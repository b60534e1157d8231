"""Tracer: nested spans over the measure → fit → serve pipeline.

The paper's whole argument is about where benchmarking time goes; the tracer
is how this repo answers that question about *itself*.  One process-global
:class:`Tracer` (installed with :func:`set_tracer` / :func:`tracing` /
``Campaign.run(trace=...)``) receives spans from every instrumented seam —
campaign phases, scheduler chunks, forest fitting, serving requests — and
appends them to a JSONL trace file.

Zero overhead when disabled — the hard contract
-----------------------------------------------
Instrumented seams include the hot measure and predict paths, so a disabled
span must cost (nearly) nothing and allocate nothing::

    with span("cache.measure_batch"):   # no tracer installed:
        ...                             # one global read + a shared singleton

:func:`span` reads one module global; when no tracer is installed it returns
the process-wide :data:`NULL_SPAN` singleton whose ``__enter__``/``__exit__``
are no-ops — no object is allocated, no clock is read, no string is formatted.
``benchmarks/bench_obs.py`` and tests/test_obs.py pin this at a few hundred
nanoseconds and zero allocations per disabled span.

Observability must never change results: spans only read clocks around
existing calls — they touch no RNG stream, no measurement order, no numeric
value.  Campaigns and served answers are bitwise identical with tracing on,
off, and mid-run (pinned in tests/test_obs.py).

Event format
------------
Records are written directly in Chrome ``trace_event`` form (``ph: "X"``
complete events plus ``"i"`` instants and ``"M"`` metadata), one JSON object
per line, timestamps in microseconds since the tracer's epoch.  The JSONL is
the append-only native format (crash-tolerant: a torn tail line loses one
event); :func:`export_chrome` wraps the events into the ``{"traceEvents":
[...]}`` JSON that ``chrome://tracing`` and https://ui.perfetto.dev load
directly.  ``pid``/``tid`` are real process/thread ids, so scheduler chunks
executed by pool workers (which report their own pid and wall-clock window
back to the parent) render as parallel tracks next to the dispatching
process.  Wall-clock times from other processes are mapped onto the trace
timeline through the epoch pair captured at construction (``time.time`` and
``time.perf_counter`` at the same instant).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Iterator, Mapping


class _NullSpan:
    """Shared no-op span: what :func:`span` returns when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


#: the singleton no-op span (never mutated, safe to re-enter concurrently)
NULL_SPAN = _NullSpan()

#: process-global active tracer (None = tracing disabled)
_TRACER: "Tracer | None" = None


def get_tracer() -> "Tracer | None":
    """The active process-global tracer, or None when tracing is disabled."""
    return _TRACER


def set_tracer(tracer: "Tracer | None") -> "Tracer | None":
    """Install ``tracer`` as the process-global tracer; returns the previous one."""
    global _TRACER
    previous = _TRACER
    _TRACER = tracer
    return previous


def span(name: str, args: Mapping | None = None, cat: str = "repro"):
    """A context-manager span on the active tracer (or the shared no-op).

    Hot paths call ``span("name")`` with no ``args`` so the disabled path
    allocates nothing; attributes known only mid-span can be attached with
    ``sp.set(k=v)`` guarded by ``if sp:`` (the null span is falsy).
    """
    tracer = _TRACER
    if tracer is None:
        return NULL_SPAN
    return _Span(tracer, name, cat, args)


def instant(name: str, args: Mapping | None = None, cat: str = "repro") -> None:
    """Emit a zero-duration marker event (retries, cache flushes, ...)."""
    tracer = _TRACER
    if tracer is not None:
        tracer.instant(name, args=args, cat=cat)


def traced(name: str | None = None, cat: str = "repro") -> Callable:
    """Decorator form of :func:`span`; the label defaults to the qualname.

    The tracer is looked up per *call*, so decorated functions stay no-op
    (one global read) when tracing is disabled.
    """

    def decorate(fn: Callable) -> Callable:
        label = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            tracer = _TRACER
            if tracer is None:
                return fn(*a, **kw)
            with _Span(tracer, label, cat, None):
                return fn(*a, **kw)

        return wrapper

    return decorate


@contextlib.contextmanager
def tracing(target) -> Iterator["Tracer | None"]:
    """Activate tracing for one block: a path creates (and closes) a tracer.

    ``target`` may be None (no-op), a path for the JSONL trace file, or a
    ready :class:`Tracer` (left open on exit — the caller owns it).  The
    previous global tracer is restored on exit, so nested activations and
    an already-installed process-global tracer compose.
    """
    if target is None:
        yield get_tracer()
        return
    owned = not isinstance(target, Tracer)
    tracer = Tracer(str(target)) if owned else target
    previous = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(previous)
        if owned:
            tracer.close()
        else:
            tracer.flush()


def enable_tracing(path: str) -> "Tracer":
    """Install a new process-global tracer writing to ``path``."""
    tracer = Tracer(path)
    set_tracer(tracer)
    return tracer


def disable_tracing() -> None:
    """Close and uninstall the process-global tracer (no-op when absent)."""
    tracer = set_tracer(None)
    if tracer is not None:
        tracer.close()


class _Span:
    """One live span: records enter/exit on the owning tracer."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = dict(args) if args else None

    def __bool__(self) -> bool:
        return True

    def set(self, **args) -> "_Span":
        if self._args is None:
            self._args = {}
        self._args.update(args)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        args = self._args
        if exc_type is not None:
            args = dict(args or ())
            args["error"] = exc_type.__name__
        tracer = self._tracer
        tracer.complete(
            self._name, self._t0, tracer.now_us() - self._t0,
            args=args, cat=self._cat,
        )
        return False


class Tracer:
    """Append-only JSONL trace writer (Chrome ``trace_event`` records).

    Thread-safe: spans may be emitted from any thread (serving handlers, the
    admission batcher, scheduler journal callbacks); each writer thread gets
    its own track via its real thread id, labelled once with an ``"M"``
    metadata event.
    """

    def __init__(self, path: str, process_name: str = "repro") -> None:
        self.path = path
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self.pid = os.getpid()
        # Epoch pair: perf_counter timestamps (monotonic, high resolution) for
        # in-process spans; the wall-clock epoch maps worker-process wall
        # windows onto the same timeline (time.time is shared across
        # processes on one host, unlike perf_counter).
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()
        self._known_tracks: set[tuple[int, int]] = set()
        self.events_written = 0
        self._write(
            {
                "ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
                "ts": 0, "args": {"name": process_name},
            }
        )

    # ---------------------------------------------------------------- clocks
    def now_us(self) -> float:
        """Microseconds since the tracer epoch (in-process timestamps)."""
        return (time.perf_counter() - self.epoch_perf) * 1e6

    def wall_us(self, wall_seconds: float) -> float:
        """Map a ``time.time()`` stamp (any process, same host) to trace time."""
        return (wall_seconds - self.epoch_wall) * 1e6

    # --------------------------------------------------------------- writing
    def _write(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self.events_written += 1

    def _track(self, pid: int, tid: int, name: str | None = None) -> None:
        """Label a (pid, tid) track once, so Perfetto shows readable names."""
        key = (pid, tid)
        # Reserve the key under the lock: the bare check-then-add was a race
        # where two threads hitting a new track both emitted metadata records
        # (found by the lock-mutation checker's review of this module).
        with self._lock:
            if key in self._known_tracks:
                return
            self._known_tracks.add(key)
        if pid != self.pid:
            self._write(
                {
                    "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "ts": 0, "args": {"name": name or f"worker-{pid}"},
                }
            )
        self._write(
            {
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "ts": 0, "args": {"name": name or threading.current_thread().name},
            }
        )

    def complete(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        args: Mapping | None = None,
        cat: str = "repro",
        pid: int | None = None,
        tid: int | None = None,
    ) -> None:
        """Emit one ``ph: "X"`` complete event."""
        if pid is None:
            pid = self.pid
        if tid is None:
            tid = threading.get_ident()
        self._track(pid, tid)
        record: dict[str, Any] = {
            "ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
            "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
        }
        if args:
            record["args"] = dict(args)
        self._write(record)

    def instant(
        self, name: str, args: Mapping | None = None, cat: str = "repro"
    ) -> None:
        pid, tid = self.pid, threading.get_ident()
        self._track(pid, tid)
        record: dict[str, Any] = {
            "ph": "i", "s": "t", "name": name, "cat": cat, "pid": pid,
            "tid": tid, "ts": round(self.now_us(), 3),
        }
        if args:
            record["args"] = dict(args)
        self._write(record)

    def worker_chunk(
        self,
        name: str,
        pid: int,
        t0_wall: float,
        t1_wall: float,
        args: Mapping | None = None,
    ) -> None:
        """Emit a chunk span measured inside a worker process.

        Workers report ``(pid, wall start, wall end)`` back with each chunk
        result; the span lands on that worker's own track (``tid = pid``), so
        a pool's concurrent chunks render as parallel lanes in Perfetto.
        """
        self._track(pid, pid, name=f"worker-{pid}")
        self.complete(
            name,
            self.wall_us(t0_wall),
            max(t1_wall - t0_wall, 0.0) * 1e6,
            args=args,
            cat="runtime.worker",
            pid=pid,
            tid=pid,
        )

    # ------------------------------------------------------------- lifecycle
    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------- export
def load_events(path: str) -> list[dict]:
    """Read a JSONL trace, skipping blank and torn (partially written) lines."""
    events: list[dict] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                continue  # torn tail line from a crash: the rest is intact
            if isinstance(record, dict):
                events.append(record)
    return events


def to_chrome(events: list[dict]) -> dict:
    """Wrap trace events into the object form Chrome/Perfetto load directly."""
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome(jsonl_path: str, out_path: str) -> int:
    """Convert a JSONL trace into a ``chrome://tracing``/Perfetto JSON file.

    Returns the number of events exported.
    """
    events = load_events(jsonl_path)
    directory = os.path.dirname(out_path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(to_chrome(events), fh)
    os.replace(tmp, out_path)
    return len(events)
