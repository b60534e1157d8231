"""Admission batcher: coalesce concurrent requests into one forest pass.

The batched ``PerfOracle`` sustains tens of thousands of queries per second
*when the queries arrive as one batch* (BENCH_engine.json); a server answering
each request with its own forest pass throws that away.  The batcher is the
request-plumbing fix: the first request to arrive opens a small admission
window (``window_s``), every request that lands inside it joins the batch,
and one ``process`` call answers all of them — each waiter is handed its
slice.  Under sustained load the window barely matters: while one batch is
being processed the next one piles up, so the steady state is
"drain-whatever-accumulated", the same adaptive behaviour a hardware
accelerator's input queue exhibits.

The batcher is deliberately generic — payloads are opaque; the server's
``process`` callable does the grouping (by platform / layer type) and the
oracle calls.  Per-item failures are supported: ``process`` may return an
``Exception`` instance in an item's result slot, and only that waiter raises.

Results are bitwise-independent of batch composition because forest
predictions are row-independent — coalescing changes wall-clock, never
answers (asserted in tests/test_serving.py).  This holds under the jitted
jax backend too: variable coalesced batch sizes are padded to power-of-two
row buckets (``repro_torch.core.jax_predict.bucket_rows``) before entering the
compiled traversal, so a different batch composition changes at most which
warm-compiled bucket runs, never a row's value — and the steady state
retraces nothing.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Sequence


class ServingError(RuntimeError):
    """A request failed inside the serving layer (batcher closed, bad op...)."""


class OverloadError(ServingError):
    """The admission queue is full: explicit backpressure, never a silent drop.

    A bounded queue turns overload into an immediate, typed answer the caller
    can retry against, instead of unbounded memory growth followed by
    latencies nobody asked for.
    """


class DeadlineExceeded(ServingError):
    """The request's deadline elapsed before its batch was answered."""


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "deadline")

    def __init__(self, payload: Any, deadline: float | None = None) -> None:
        self.payload = payload
        self.event = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None
        #: absolute ``perf_counter`` deadline; None = wait forever
        self.deadline = deadline


class AdmissionBatcher:
    """Coalesces concurrent blocking ``submit`` calls into ``process`` batches."""

    def __init__(
        self,
        process: Callable[[Sequence[Any]], Sequence[Any]],
        window_s: float = 0.002,
        max_batch: int = 4096,
        on_batch: Callable[[int], None] | None = None,
        name: str = "oracle",
        max_queue: int | None = None,
    ) -> None:
        self.process = process
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.on_batch = on_batch
        #: admission-queue bound; a submit beyond it raises ``OverloadError``
        #: (None = unbounded, the pre-overload-control behaviour)
        self.max_queue = None if max_queue is None else max(1, int(max_queue))
        self._cond = threading.Condition()
        self._queue: list[_Pending] = []
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=f"admission-batcher-{name}", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ client
    def submit(self, payload: Any, deadline_s: float | None = None) -> Any:
        """Enqueue one request and block until its batch is answered.

        ``deadline_s`` bounds the wait (seconds from now): a request still
        queued when it elapses raises :class:`DeadlineExceeded` — it is
        *answered*, not dropped; an overflowing queue raises
        :class:`OverloadError` immediately.
        """
        deadline = None if deadline_s is None else time.perf_counter() + deadline_s
        pending = _Pending(payload, deadline=deadline)
        with self._cond:
            if self._closed:
                raise ServingError("batcher is closed")
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                raise OverloadError(
                    f"admission queue is full ({self.max_queue} pending); "
                    f"retry with backoff"
                )
            self._queue.append(pending)
            # Wake the dispatcher only at the transitions it acts on: the
            # arrival that opens a window and the one that fills the batch.
            # Intermediate arrivals just join the queue — waking the
            # dispatcher for each would burn a GIL bounce per request.
            n = len(self._queue)
            if n == 1 or n >= self.max_batch:
                self._cond.notify_all()
        if deadline is None:
            pending.event.wait()
        else:
            remaining = deadline - time.perf_counter()
            if not pending.event.wait(timeout=max(0.0, remaining)):
                # The dispatcher may still answer this entry later; nobody
                # will read it. The deadline is the caller's contract.
                raise DeadlineExceeded(
                    f"deadline of {deadline_s}s elapsed before the batch answered"
                )
        if pending.error is not None:
            raise pending.error
        return pending.result

    # ------------------------------------------------------------- dispatcher
    def _drain_locked(self) -> tuple[list[_Pending], list[_Pending]]:
        """Split the queue head into (batch, expired-before-dispatch)."""
        now = time.perf_counter()
        batch: list[_Pending] = []
        expired: list[_Pending] = []
        keep: list[_Pending] = []
        for pending in self._queue:
            if pending.deadline is not None and pending.deadline <= now:
                expired.append(pending)
            elif len(batch) < self.max_batch:
                batch.append(pending)
            else:
                keep.append(pending)
        self._queue[:] = keep
        return batch, expired

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # Admission window: the batch that opened it picks up every
                # request arriving within window_s (each arrival notifies).
                deadline = time.perf_counter() + self.window_s
                while len(self._queue) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(timeout=remaining)
                batch, expired = self._drain_locked()
            for pending in expired:
                # Answered, never silently dropped: the waiter (likely gone
                # already — its own wait timed out) gets the typed error.
                pending.error = DeadlineExceeded(
                    "deadline elapsed while queued for admission"
                )
                pending.event.set()
            self._dispatch(batch)

    def _dispatch(self, batch: list[_Pending]) -> None:
        if not batch:
            return
        if self.on_batch is not None:
            try:
                self.on_batch(len(batch))
            except Exception:
                pass  # metrics must never fail a batch
        try:
            results = self.process([p.payload for p in batch])
            if len(results) != len(batch):
                raise ServingError(
                    f"process returned {len(results)} results for a "
                    f"{len(batch)}-request batch"
                )
        except BaseException as exc:  # noqa: BLE001 - fanned out to waiters
            for p in batch:
                p.error = exc
                p.event.set()
            return
        for p, r in zip(batch, results):
            if isinstance(r, BaseException):
                p.error = r
            else:
                p.result = r
            p.event.set()

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop accepting work; queued requests are still answered."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)

    def __enter__(self) -> "AdmissionBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
