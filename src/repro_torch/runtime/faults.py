"""Deterministic fault injection for the measurement runtime (chaos layer).

A :class:`FaultPlan` is a replayable schedule of infrastructure faults —
worker crashes, hangs, slow deliveries, corrupted result payloads, torn
journal writes — that the runtime consults at two injection points:

* **chunk submissions** — :class:`FaultyExecutor` wraps any executor and
  keys events by *submission ordinal* (0 for the first chunk submitted, 1
  for the next, including resubmissions).  The dispatch loop submits chunks
  in a deterministic order, so with a serial executor a plan replays
  exactly; with a pool, retry ordinals depend on completion timing — which
  is the point: the bitwise-identity invariant must hold for *any*
  interleaving, so chaos tests pin exact replays on the serial path and
  schedule-independence on the pool path.
* **journal appends** — :meth:`MeasurementJournal._append_record
  <repro_torch.runtime.journal.MeasurementJournal>` keys ``torn_write`` events by
  append ordinal; a fired event writes half a record (no newline), fsyncs,
  and raises :class:`TornWrite`, emulating a crash mid-``write(2)``.

Plans are either hand-written (``FaultPlan([FaultEvent(...)])``) or sampled
reproducibly from a seed (:meth:`FaultPlan.sample`) — the same
``(seed, schedule parameters)`` always yields the same schedule, so every
chaos failure is replayable from its seed.

Injected faults are *indistinguishable from real ones* by construction: a
``crash`` is a future that fails like a died worker, a ``corrupt`` result
keeps its stale integrity envelope (the scheduler must catch it by checksum,
exactly as it would catch IPC bit rot), a ``torn_write`` leaves real torn
bytes on disk.  Nothing in the recovery path is test-only.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future

import numpy as np

#: fault kinds injectable at the chunk-submission site
CHUNK_KINDS = ("crash", "hang", "slow", "corrupt")
#: fault kinds injectable at the journal-append site
JOURNAL_KINDS = ("torn_write",)
FAULT_KINDS = CHUNK_KINDS + JOURNAL_KINDS

#: injection-site names (``FaultEvent.site``)
CHUNK_SITE = "chunk"
JOURNAL_SITE = "journal"
_SITE_KINDS = {CHUNK_SITE: CHUNK_KINDS, JOURNAL_SITE: JOURNAL_KINDS}


class InjectedFault(RuntimeError):
    """Base class for faults raised by a :class:`FaultPlan`."""


class InjectedWorkerCrash(InjectedFault):
    """A chunk submission was killed by the plan (emulated worker death)."""


class TornWrite(InjectedFault):
    """A journal append was torn mid-record by the plan (emulated crash)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: *kind* fires at *site* ordinal *index*.

    ``delay_s`` is the delivery delay for ``hang``/``slow`` events — a hang
    is just a slow event sized past ``chunk_timeout_s`` so the scheduler's
    timeout machinery (not the plan) decides it hung.
    """

    site: str
    index: int
    kind: str
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.site not in _SITE_KINDS:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in _SITE_KINDS[self.site]:
            raise ValueError(
                f"fault kind {self.kind!r} is not injectable at site {self.site!r}"
            )
        if self.index < 0:
            raise ValueError("fault index must be >= 0")
        if self.delay_s < 0:
            raise ValueError("fault delay_s must be >= 0")


class FaultPlan:
    """A deterministic, consumable schedule of :class:`FaultEvent`\\ s.

    ``take(site, index)`` returns the event scheduled for that injection
    point (at most once — a fired event is consumed) or ``None``.  Thread
    safe: pool callbacks and timer threads may consult the plan while the
    dispatch thread submits.
    """

    def __init__(self, events=()) -> None:
        self.events = tuple(events)
        for event in self.events:
            if not isinstance(event, FaultEvent):
                raise TypeError(f"not a FaultEvent: {event!r}")
        self._lock = threading.Lock()
        self._pending: dict[tuple[str, int], FaultEvent] = {}
        for event in self.events:
            key = (event.site, event.index)
            if key in self._pending:
                raise ValueError(f"duplicate fault at {key}")
            self._pending[key] = event
        self._fired: list[FaultEvent] = []

    @classmethod
    def sample(
        cls,
        seed: int,
        n_faults: int = 4,
        horizon: int = 24,
        kinds: tuple[str, ...] = CHUNK_KINDS,
        journal_faults: int = 0,
        journal_horizon: int = 24,
        hang_s: float = 0.25,
        slow_s: float = 0.02,
    ) -> "FaultPlan":
        """Draw a reproducible schedule: same arguments => same plan.

        ``n_faults`` chunk-site events land on distinct submission ordinals
        in ``[0, horizon)``; ``journal_faults`` torn writes land on distinct
        append ordinals in ``[0, journal_horizon)``.
        """
        for kind in kinds:
            if kind not in CHUNK_KINDS:
                raise ValueError(f"{kind!r} is not a chunk-site fault kind")
        rng = np.random.default_rng(seed)
        events = []
        n_chunk = min(int(n_faults), int(horizon))
        ordinals = rng.choice(int(horizon), size=n_chunk, replace=False)
        for ordinal in sorted(int(o) for o in ordinals):
            kind = kinds[int(rng.integers(len(kinds)))]
            delay = hang_s if kind == "hang" else slow_s if kind == "slow" else 0.0
            events.append(FaultEvent(CHUNK_SITE, ordinal, kind, delay_s=delay))
        n_journal = min(int(journal_faults), int(journal_horizon))
        if n_journal > 0:
            # repro-lint: disable=rng-discipline -- locked stream: the predicate
            # depends only on sample()'s own arguments, which are the plan's
            # full key; same arguments always replay the same draw positions
            appends = rng.choice(int(journal_horizon), size=n_journal, replace=False)
            for ordinal in sorted(int(o) for o in appends):
                events.append(FaultEvent(JOURNAL_SITE, ordinal, "torn_write"))
        return cls(events)

    @property
    def exhausted(self) -> bool:
        """True once every scheduled event has fired (lock-free read).

        ``_pending`` only ever shrinks, so a racy read can at worst report
        ``False`` for a plan that just emptied — never the reverse.  The
        healthy path checks this before paying any lock.
        """
        return not self._pending

    def take(self, site: str, index: int) -> FaultEvent | None:
        """Consume and return the event for this injection point, if any."""
        with self._lock:
            event = self._pending.pop((site, index), None)
            if event is not None:
                self._fired.append(event)
            return event

    def fired(self) -> tuple[FaultEvent, ...]:
        with self._lock:
            return tuple(self._fired)

    def describe(self) -> list[dict]:
        """JSON-friendly view of the schedule (for reports and benches)."""
        return [dataclasses.asdict(event) for event in self.events]


def _deliver(src: Future, dst: Future) -> None:
    """Copy a finished future's outcome onto a proxy (ignoring cancellation)."""
    try:
        exc = src.exception()
        if exc is not None:
            dst.set_exception(exc)
        else:
            dst.set_result(src.result())
    except Exception:
        # the proxy was cancelled by the scheduler's retry machinery, or the
        # source was cancelled out from under us — either way nobody is
        # waiting on this delivery anymore
        pass


def _delayed_future(inner: Future, delay_s: float) -> Future:
    """Proxy whose outcome arrives ``delay_s`` after the inner future's."""
    proxy: Future = Future()

    def arm(src: Future) -> None:
        timer = threading.Timer(delay_s, _deliver, args=(src, proxy))
        timer.daemon = True
        timer.start()

    inner.add_done_callback(arm)
    return proxy


def corrupt_payload(y: np.ndarray) -> np.ndarray:
    """Flip the lowest mantissa bit of every value (emulated transit bit rot).

    The change is numerically tiny but bitwise-detectable — exactly the
    failure mode an integrity envelope exists to catch, since a corrupted
    payload that *merged* would silently break bitwise reproducibility.
    """
    corrupted = np.ascontiguousarray(y, dtype=np.float64).copy()
    corrupted.view(np.uint64)[...] ^= np.uint64(1)
    return corrupted


def _corrupted_future(inner: Future) -> Future:
    """Proxy that corrupts the payload while keeping the stale checksum."""
    proxy: Future = Future()

    def deliver(src: Future) -> None:
        try:
            exc = src.exception()
            if exc is not None:
                proxy.set_exception(exc)
                return
            result = src.result()
            if isinstance(result, tuple):
                proxy.set_result((corrupt_payload(result[0]),) + tuple(result[1:]))
            else:
                proxy.set_result(corrupt_payload(result))
        except Exception:
            pass  # proxy cancelled; nobody is waiting

    inner.add_done_callback(deliver)
    return proxy


class FaultyExecutor:
    """Executor wrapper that applies a :class:`FaultPlan` at submission time.

    Presents the executor protocol the scheduler drives (``submit``,
    ``submit_blocks``, ``workers``, optional ``respawn``/``quarantine``,
    ``close``) and passes everything through the wrapped executor, faulting
    individual submissions per the plan.  ``report`` (a
    :class:`~repro_torch.runtime.health.DegradationReport`) gets one ``injected``
    entry per fired event so runs can prove the plan actually bit.
    """

    def __init__(self, inner, plan: FaultPlan, report=None) -> None:
        self.inner = inner
        self.plan = plan
        self.report = report
        self._lock = threading.Lock()
        self._ordinal = 0

    @property
    def workers(self) -> int:
        return int(getattr(self.inner, "workers", 1))

    def submit(self, layer_type, batch) -> Future:
        # Exhausted plan: nothing left to inject, and the ordinal no longer
        # matters — straight pass-through (no locks, no closure) so the chaos
        # layer costs (almost) nothing once every event has fired.
        if self.plan.exhausted:
            return self.inner.submit(layer_type, batch)
        return self._apply(lambda: self.inner.submit(layer_type, batch))

    def submit_blocks(self, batch) -> Future:
        if self.plan.exhausted:
            return self.inner.submit_blocks(batch)
        return self._apply(lambda: self.inner.submit_blocks(batch))

    def _apply(self, submit) -> Future:
        with self._lock:
            ordinal = self._ordinal
            self._ordinal += 1
        event = self.plan.take(CHUNK_SITE, ordinal)
        if event is None:
            return submit()
        if self.report is not None:
            self.report.record(
                "injected", site=event.site, index=event.index, fault=event.kind
            )
        if event.kind == "crash":
            future: Future = Future()
            future.set_exception(
                InjectedWorkerCrash(f"injected worker crash at submission {ordinal}")
            )
            return future
        inner = submit()
        if event.kind == "corrupt":
            return _corrupted_future(inner)
        return _delayed_future(inner, event.delay_s)  # hang / slow

    def __getattr__(self, name: str):
        # expose respawn/quarantine only when the wrapped executor has them,
        # so the scheduler's capability probes see the true surface
        if name in ("respawn", "quarantine"):
            return getattr(self.inner, name)
        raise AttributeError(name)

    def close(self, *args, **kwargs) -> None:
        return self.inner.close(*args, **kwargs)


__all__ = [
    "CHUNK_KINDS",
    "CHUNK_SITE",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "FaultyExecutor",
    "InjectedFault",
    "InjectedWorkerCrash",
    "JOURNAL_KINDS",
    "JOURNAL_SITE",
    "TornWrite",
    "corrupt_payload",
]
