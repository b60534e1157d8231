"""MeasurementScheduler: shard a miss sub-batch into chunks, dispatch, merge.

The scheduler is the deterministic heart of the runtime: a batch of ``n``
configurations *or building blocks* is cut into contiguous chunks, every
chunk is submitted to the executor up front (so a pool keeps all workers
busy), and results are merged back **positionally** — chunk ``i`` always
owns rows ``[a, b)`` of the output, i.e. the batch's first-occurrence order.
Chunk boundaries never depend on worker count or completion order, so a
campaign produces bitwise-identical results with 1, 2 or 16 workers; and
because the positional merge is order-preserving regardless of where the
chunk boundaries fall, the chunk size itself cannot change results either —
which is what makes adaptive sizing safe.

Chunk sizing: an explicit ``chunk_size`` is honored as-is.  With
``chunk_size=None`` (the default via :class:`~repro_torch.runtime.RuntimeSpec`),
the scheduler derives the size from the run's own measured per-item cost so
one chunk lands near ``target_chunk_s`` (~1 s) of wall time — big enough to
amortize IPC for cheap analytical models, small enough to keep retries and
journal granularity useful for multi-second hardware measurements.  Before
any cost data exists it starts at :data:`DEFAULT_CHUNK_SIZE`.

Fault handling per chunk — the dispatch loop is an event loop over chunk
completions, so one chunk's failure never stalls the others:

* an executor failure (worker crash, measurement exception), a corrupt
  payload (integrity-envelope mismatch, :class:`ResultIntegrityError`) or a
  per-attempt timeout (``chunk_timeout_s``) schedules a resubmission with
  exponential backoff on a timer — only the failed chunk waits out its
  backoff; every other in-flight chunk keeps completing and merging
  meanwhile;
* failures feed the optional :class:`~repro_torch.runtime.health.HealthTracker`;
  a repeat-offender worker gets quarantined (``executor.quarantine`` —
  pool shrink-and-respawn) and every fault survived is recorded on
  ``stats.degradation`` (:class:`~repro_torch.runtime.health.DegradationReport`);
* a chunk that exhausts its budget raises :class:`MeasurementError` naming
  the chunk, its size and the attempts spent — the journal still holds
  every chunk that completed before it, so a re-run resumes instead of
  starting over.

Completed chunks are appended to the :class:`~repro_torch.runtime.journal
.MeasurementJournal` (fsync'd) the moment they *complete* — out of merge
order when a pool finishes them out of order — so a kill loses only the
chunks still in flight, never completed work.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import CancelledError
from concurrent.futures.process import BrokenProcessPool
from typing import Callable

import numpy as np

from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer, instant, span
from repro_torch.runtime.faults import InjectedWorkerCrash, TornWrite
from repro_torch.runtime.health import HealthTracker
from repro_torch.runtime.journal import MeasurementJournal
from repro_torch.runtime.stats import RunStats
from repro_torch.runtime.workers import chunk_checksum

#: chunk size used before the run has any per-item cost data (PR-3's fixed
#: default, kept so fresh runs behave exactly as they used to)
DEFAULT_CHUNK_SIZE = 64
#: adaptive sizing never exceeds this (bounds retry/journal granularity)
MAX_CHUNK_SIZE = 4096


class MeasurementError(RuntimeError):
    """A chunk failed permanently (retry budget exhausted)."""


class ResultIntegrityError(RuntimeError):
    """A chunk payload failed its integrity envelope (checksum mismatch).

    ``pid`` names the worker whose envelope did not verify (when the chunk
    meta carried one), so the health tracker can attribute the failure.
    """

    def __init__(self, message: str, pid: int | None = None) -> None:
        super().__init__(message)
        self.pid = pid


def _classify_failure(exc: BaseException) -> str:
    """Map a chunk failure to its :class:`DegradationReport` kind."""
    if isinstance(exc, ResultIntegrityError):
        return "corrupt"
    if isinstance(exc, TimeoutError):
        return "hang"
    if isinstance(exc, (InjectedWorkerCrash, BrokenProcessPool)):
        return "crash"
    return "error"


class _ChunkState:
    """Dispatch-loop bookkeeping for one chunk (guarded by the loop's lock)."""

    __slots__ = ("index", "sub", "a", "b", "future", "attempts", "gen",
                 "deadline", "fatal", "merged", "epoch")

    def __init__(self, index: int, sub, a: int, b: int) -> None:
        self.index = index
        self.sub = sub
        self.a = a
        self.b = b
        self.future = None
        self.attempts = 0       # failed attempts so far
        self.gen = 0            # bumped per (re)submission/failure: staleness token
        self.deadline = None    # perf_counter deadline of the current attempt
        self.fatal = None       # resubmission error => immediate MeasurementError
        self.merged = False
        self.epoch = 0          # pool epoch of the current attempt's submission


class MeasurementScheduler:
    """Chunked, retrying dispatch of measurement batches over an executor."""

    def __init__(
        self,
        executor,
        journal: MeasurementJournal | None = None,
        chunk_size: int | None = None,
        max_retries: int = 2,
        retry_backoff_s: float = 0.05,
        chunk_timeout_s: float | None = None,
        target_chunk_s: float = 1.0,
        stats: RunStats | None = None,
        health: HealthTracker | None = None,
    ) -> None:
        self.executor = executor
        self.journal = journal
        self.chunk_size = None if chunk_size is None else max(1, int(chunk_size))
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.chunk_timeout_s = chunk_timeout_s
        self.target_chunk_s = float(target_chunk_s)
        self.stats = stats if stats is not None else RunStats()
        self.health = health
        #: serializes respawn-on-broken-submit: retry timers resubmit
        #: concurrently after a worker death, and exactly one of them may
        #: rebuild the pool
        self._respawn_serial = threading.Lock()
        #: bumped on every pool respawn/quarantine; chunk failures whose
        #: attempt was submitted under an older epoch are *collateral* of the
        #: teardown, not evidence about a worker — retried, but never fed to
        #: the health tracker (that feedback loop is what a quarantine cascade
        #: is made of)
        self._pool_epoch = 0
        #: per-path (configs vs blocks) [items, wall seconds] cost pools for
        #: adaptive sizing — a block costs orders of magnitude more than a
        #: single config, so one runtime serving both paths must not size
        #: block chunks from config costs (or vice versa)
        self._path_costs: dict[str, list[float]] = {
            "configs": [0, 0.0],
            "blocks": [0, 0.0],
        }
        #: per-path [items, executor-side seconds] pools: execution time
        #: reported by the worker itself (around the platform call only, no
        #: IPC/pickling/queue wait) — the preferred cost signal when present
        self._exec_costs: dict[str, list[float]] = {
            "configs": [0, 0.0],
            "blocks": [0, 0.0],
        }

    # ------------------------------------------------------------- chunk sizing
    def effective_chunk_size(self, path: str = "configs") -> int:
        """Chunk size for the next batch: explicit setting, or adaptive.

        Adaptive sizing targets ``target_chunk_s`` of execution time per
        chunk, from the cost pool of the *same path* (config items and block
        items have very different unit costs).  Two cost signals exist:

        * **executor-side** (preferred): workers time the platform call
          itself and return ``(times, exec_seconds)``; a chunk runs on one
          worker, so the size is simply ``target / per_item_exec`` — no
          dispatch noise, no worker-count fudge;
        * **dispatch wall** (fallback, for executors that return bare
          arrays): dispatch-loop time, during which a saturated pool of
          ``w`` workers measures ``w`` items concurrently — so the true
          per-item cost is roughly ``w`` times the observed per-item wall,
          and the size works out to ``target / (per_item_wall * workers)``.
        """
        if self.chunk_size is not None:
            return self.chunk_size
        measured, spent = self._exec_costs.get(path, (0, 0.0))
        if measured > 0 and spent > 0.0:
            size = int(self.target_chunk_s / (spent / measured))
            return max(1, min(size, MAX_CHUNK_SIZE))
        measured, spent = self._path_costs.get(path, (0, 0.0))
        if measured <= 0 or spent <= 0.0:
            return DEFAULT_CHUNK_SIZE
        per_item_wall = spent / measured
        workers = max(1, int(getattr(self.executor, "workers", 1)))
        size = int(self.target_chunk_s / (per_item_wall * workers))
        return max(1, min(size, MAX_CHUNK_SIZE))

    @staticmethod
    def _split_result(result) -> tuple:
        """Split an executor result into ``(times, exec_seconds | None, meta | None)``.

        The built-in executors return ``(times, exec_seconds, meta)`` with
        the worker-side chunk execution time and trace provenance (worker
        pid + wall window, see :func:`repro_torch.runtime.workers._chunk_meta`).
        Third-party executors may return the older ``(times, exec_seconds)``
        pair or a bare array — all three are accepted; missing elements just
        contribute no cost sample / no worker-track trace span.
        """
        if isinstance(result, tuple) and isinstance(result[-1], dict):
            y, exec_s, meta = result
            return y, float(exec_s), meta
        if (
            isinstance(result, tuple)
            and len(result) == 2
            and isinstance(result[1], (int, float))
        ):
            return result[0], float(result[1]), None
        return result, None, None

    def _validate_result(self, result, n: int) -> tuple:
        """Split, shape-check and integrity-check one chunk result.

        Raises ``ValueError`` on a malformed shape and
        :class:`ResultIntegrityError` when the chunk meta carries an
        integrity envelope (``crc``, see
        :func:`repro_torch.runtime.workers.chunk_checksum`) that does not verify
        against the delivered payload.  Executors without an envelope are
        accepted as before — the check is opt-in by construction.
        """
        y, exec_s, meta = self._split_result(result)
        y = np.asarray(y, dtype=np.float64)
        if y.shape != (n,):
            raise ValueError(
                f"executor returned shape {y.shape} for a {n}-row chunk"
            )
        if meta is not None and "crc" in meta and chunk_checksum(y) != meta["crc"]:
            raise ResultIntegrityError(
                "chunk payload failed its integrity envelope (crc mismatch)",
                pid=meta.get("pid"),
            )
        return y, exec_s, meta

    # ----------------------------------------------------------------- dispatch
    def measure_batch(
        self, platform_key: str, layer_type: str, batch: ConfigBatch
    ) -> np.ndarray:
        """Measure a whole config batch; returns times aligned with its rows."""
        n = len(batch)
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        chunk = self.effective_chunk_size("configs")
        bounds = [(a, min(a + chunk, n)) for a in range(0, n, chunk)]
        subs = [
            ConfigBatch(params=batch.params, values=batch.values[a:b]) for a, b in bounds
        ]
        journal_append = None
        if self.journal is not None:
            journal_append = lambda sub, y: self.journal.append_chunk(  # noqa: E731
                platform_key, layer_type, sub, y
            )
        return self._execute(
            subs,
            bounds,
            n,
            submit=lambda sub: self.executor.submit(layer_type, sub),
            journal_append=journal_append,
            label=layer_type,
            path="configs",
        )

    def measure_block_batch(self, platform_key: str, batch: BlockBatch) -> np.ndarray:
        """Measure a whole block batch; same chunking/retry/journal machinery.

        Chunks are contiguous *block* ranges (a chunk carries all of its
        blocks' layers), dispatched through the executor's ``submit_blocks``
        and journaled as block records, so whole-network calibration gets the
        same determinism, fault-tolerance and crash-safe resume as the config
        path.
        """
        n = len(batch)
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        chunk = self.effective_chunk_size("blocks")
        bounds = [(a, min(a + chunk, n)) for a in range(0, n, chunk)]
        subs = [batch.take(np.arange(a, b)) for a, b in bounds]
        journal_append = None
        if self.journal is not None:
            journal_append = lambda sub, y: self.journal.append_block_chunk(  # noqa: E731
                platform_key, sub, y
            )
        return self._execute(
            subs,
            bounds,
            n,
            submit=self.executor.submit_blocks,
            journal_append=journal_append,
            label="<blocks>",
            path="blocks",
        )

    def _execute(
        self,
        subs: list,
        bounds: list[tuple[int, int]],
        n: int,
        submit: Callable,
        journal_append: Callable | None,
        label: str,
        path: str = "configs",
    ) -> np.ndarray:
        # A pool wants every chunk queued up front so all workers stay busy; a
        # serial executor measures *at submit time*, so eager submission would
        # complete the whole batch before the first journal append — one chunk
        # at a time keeps the journal's loses-at-most-one-chunk guarantee.
        prefetch = getattr(self.executor, "workers", 1) > 1
        workers = max(1, int(getattr(self.executor, "workers", 1)))
        health = self.health  # hoisted: consulted once per merged chunk
        t0 = time.perf_counter()
        measured_before = self.stats.measured
        out = np.empty(n, dtype=np.float64)
        # Durability is per *completed* chunk, not per merged chunk: with a
        # pool, chunks finish out of order while the merge loop works on the
        # oldest ones, so successful futures journal themselves immediately
        # via done-callbacks.  The merge step stays authoritative: a timed-out
        # attempt may complete late and journal values the run then discards
        # in favour of its retry, so the merge step appends a *superseding*
        # record whenever the journaled values differ from the values actually
        # merged (journal replay is last-writer-wins), and ``finalized``
        # blocks any straggler callback from journaling after that.
        journal_lock = threading.Lock()
        journaled: dict[int, np.ndarray] = {}
        finalized: set[int] = set()

        def journal_chunk(index: int, y: np.ndarray, authoritative: bool) -> None:
            if journal_append is None:
                return
            with journal_lock:
                if authoritative:
                    previous = journaled.get(index)
                    if previous is None or not np.array_equal(previous, y):
                        journal_append(subs[index], y)
                        journaled[index] = y
                    finalized.add(index)
                elif index not in finalized and index not in journaled:
                    journal_append(subs[index], y)
                    journaled[index] = y

        def completion_callback(index: int):
            def callback(fut) -> None:
                if fut.cancelled() or fut.exception() is not None:
                    return
                try:
                    y, _, _ = self._validate_result(fut.result(), len(subs[index]))
                except Exception:
                    return  # malformed/corrupt result: the retry machinery owns it
                try:
                    journal_chunk(index, y, authoritative=False)
                except Exception:
                    pass  # append errors re-raise from the merge step's call
            return callback

        # ---- completion-event loop state --------------------------------
        # Every (re)submission's done-callback enqueues ``(index, gen)``;
        # ``gen`` is a staleness token so a timed-out attempt completing
        # after its retry was scheduled cannot be mistaken for the retry.
        # All _ChunkState mutation happens under ``state_lock`` — retry
        # timers run on their own threads.
        states = [_ChunkState(i, subs[i], a, b) for i, (a, b) in enumerate(bounds)]
        events: queue.SimpleQueue = queue.SimpleQueue()
        state_lock = threading.Lock()
        timers: list[threading.Timer] = []
        aborted = [False]

        def launch(state: _ChunkState) -> None:
            # First submission of a chunk (dispatch thread only).
            future = self._submit(submit, state.sub, label)
            if prefetch and journal_append is not None:
                future.add_done_callback(completion_callback(state.index))
            with state_lock:
                state.future = future
                state.gen += 1
                state.epoch = self._pool_epoch
                gen = state.gen
                if self.chunk_timeout_s is not None:
                    # Prefetched chunk i queues behind ~i/workers earlier
                    # chunks on its worker; give later chunks proportional
                    # slack so a saturated pool doesn't time them out while
                    # they are merely waiting their turn.
                    slack = 1 + (state.index // workers if prefetch else 0)
                    state.deadline = time.perf_counter() + self.chunk_timeout_s * slack
            future.add_done_callback(lambda _: events.put((state.index, gen)))

        def schedule_retry(state: _ChunkState, attempt: int) -> None:
            # Only this chunk sleeps out its backoff — on a timer thread,
            # while the event loop keeps merging every other chunk.
            delay = self.retry_backoff_s * (2 ** (attempt - 1))

            def fire() -> None:
                with state_lock:
                    if aborted[0]:
                        return
                try:
                    future = self._submit(submit, state.sub, label)
                except Exception as submit_exc:
                    with state_lock:
                        state.fatal = submit_exc
                        gen = state.gen
                    events.put((state.index, gen))
                    return
                with state_lock:
                    if aborted[0]:
                        future.cancel()
                        return
                    state.future = future
                    state.gen += 1
                    state.epoch = self._pool_epoch
                    gen = state.gen
                    if self.chunk_timeout_s is not None:
                        # A resubmission lands at the back of the pool's
                        # queue, behind every still-in-flight chunk, so a
                        # fixed timeout would burn the whole retry budget on
                        # queue wait alone; scale the window by the number of
                        # chunks ahead of it.
                        state.deadline = time.perf_counter() + self.chunk_timeout_s * (
                            1 + max(0, self.stats.in_flight)
                        )
                future.add_done_callback(lambda _: events.put((state.index, gen)))

            timer = threading.Timer(delay, fire)
            timer.daemon = True
            timers.append(timer)
            timer.start()

        def fail(state: _ChunkState, exc: BaseException) -> None:
            state.attempts += 1
            attempt = state.attempts
            if attempt > self.max_retries:
                self.stats.failures += 1
                obs_metrics().inc("runtime.failures")
                raise MeasurementError(
                    f"chunk {state.index} of {label!r} ({len(state.sub)} items) "
                    f"failed after {attempt} attempt(s): {exc}"
                ) from exc
            self.stats.retries += 1
            obs_metrics().inc("runtime.retries")
            kind = _classify_failure(exc)
            self.stats.degradation.record(
                kind, chunk=state.index, attempt=attempt, error=type(exc).__name__
            )
            obs_metrics().inc(f"runtime.faults.{kind}")
            if get_tracer() is not None:
                instant(
                    "runtime.retry",
                    {"label": label, "chunk": state.index, "attempt": attempt,
                     "error": type(exc).__name__},
                    cat="runtime",
                )
            # A respawn/quarantine kills the old pool under every in-flight
            # chunk: their BrokenProcessPool / cancellation failures are
            # collateral of *our own* teardown, not evidence about a worker.
            # Feeding them to the health tracker would let one quarantine
            # trigger the next (each teardown fails the survivors, each
            # failure advances the streak) until the retry budget starves.
            collateral = state.epoch < self._pool_epoch and isinstance(
                exc, (BrokenProcessPool, CancelledError)
            )
            if (
                not collateral
                and self.health is not None
                and self.health.record_failure(getattr(exc, "pid", None))
            ):
                self._quarantine(getattr(exc, "pid", None))
            with state_lock:
                state.gen += 1  # events from the failed attempt are now stale
                future = state.future
                state.future = None
                state.deadline = None
            if future is not None:
                future.cancel()
            schedule_retry(state, attempt)

        def merge(state: _ChunkState, y, exec_s, meta) -> None:
            out[state.a : state.b] = y
            with state_lock:
                state.merged = True
                state.future = None
                state.deadline = None
            self.stats.in_flight -= 1
            self.stats.chunks += 1
            self.stats.measured += state.b - state.a
            chunk_counter.inc()
            if exec_s is not None:
                self.stats.exec_seconds += exec_s
                exec_hist.observe(exec_s)
                exec_pool = self._exec_costs.setdefault(path, [0, 0.0])
                exec_pool[0] += state.b - state.a
                exec_pool[1] += exec_s
            tracer = get_tracer()
            if tracer is not None and meta is not None and "pid" in meta:
                # Replay the chunk's worker-side wall window onto a
                # per-worker track (tid = worker pid) so pool chunks show
                # up as parallel lanes in Perfetto.
                tracer.worker_chunk(
                    f"chunk[{label}]",
                    meta["pid"],
                    meta["t0"],
                    meta["t1"],
                    args={"index": state.index, "items": state.b - state.a},
                )
            if health is not None:
                pid = meta.get("pid") if meta is not None else None
                if health.record_success(pid, exec_s) == "slow":
                    self.stats.degradation.record(
                        "slow", chunk=state.index, pid=pid, exec_s=exec_s
                    )
                    obs_metrics().inc("runtime.faults.slow")
            try:
                journal_chunk(state.index, y, authoritative=True)
            except TornWrite:
                self.stats.degradation.record("torn_write", chunk=state.index)
                raise

        reg = obs_metrics()
        chunk_counter = reg.counter("runtime.chunks")
        exec_hist = reg.histogram(f"runtime.{path}.chunk_exec_s")
        dispatch = span("runtime.dispatch", cat="runtime")
        if dispatch:
            dispatch.set(label=label, path=path, items=n, chunks=len(bounds))
        try:
            dispatch.__enter__()
            if prefetch:
                self.stats.in_flight += len(states)
                for state in states:
                    launch(state)
            else:
                self.stats.in_flight += 1
                launch(states[0])
            next_serial = 1
            unmerged = len(states)
            while unmerged:
                with state_lock:
                    deadlines = [
                        s.deadline
                        for s in states
                        if not s.merged and s.deadline is not None
                    ]
                timeout = None
                if deadlines:
                    timeout = max(0.0, min(deadlines) - time.perf_counter())
                try:
                    index, gen = events.get(timeout=timeout)
                except queue.Empty:
                    index = None
                if index is not None:
                    state = states[index]
                    with state_lock:
                        fatal = state.fatal
                        stale = state.merged or gen != state.gen
                        future = state.future
                    if fatal is not None:
                        self.stats.failures += 1
                        obs_metrics().inc("runtime.failures")
                        raise MeasurementError(
                            f"chunk {state.index} of {label!r} could not be "
                            f"resubmitted after a failed attempt: {fatal}"
                        ) from fatal
                    if not stale and future is not None and future.done():
                        if future.cancelled():
                            # fail() bumps ``gen`` before cancelling, so its
                            # own cancellations always arrive stale; a *live*
                            # cancellation can only come from pool teardown
                            # (respawn/quarantine cancels queued futures) and
                            # must retry like any other attempt failure —
                            # dropping it would leave the chunk unmerged
                            # forever and hang the dispatch loop.
                            fail(
                                state,
                                CancelledError(
                                    f"chunk {state.index} attempt cancelled "
                                    "by pool teardown"
                                ),
                            )
                        elif future.exception() is not None:
                            fail(state, future.exception())
                        else:
                            try:
                                y, exec_s, meta = self._validate_result(
                                    future.result(), len(state.sub)
                                )
                            except Exception as bad:
                                fail(state, bad)
                            else:
                                merge(state, y, exec_s, meta)
                                unmerged -= 1
                                if not prefetch and next_serial < len(states):
                                    self.stats.in_flight += 1
                                    launch(states[next_serial])
                                    next_serial += 1
                # Sweep expired deadlines even after processing an event: a
                # hung chunk must not wait behind a busy completion queue.
                if self.chunk_timeout_s is not None:
                    now = time.perf_counter()
                    expired = []
                    with state_lock:
                        for s in states:
                            if (
                                not s.merged
                                and s.deadline is not None
                                and s.future is not None
                                and now >= s.deadline
                                and not s.future.done()
                            ):
                                expired.append(s)
                    for s in expired:
                        fail(
                            s,
                            TimeoutError(
                                f"chunk {s.index} attempt timed out after "
                                f"{self.chunk_timeout_s}s"
                            ),
                        )
        finally:
            with state_lock:
                aborted[0] = True
            for timer in timers:
                timer.cancel()
            dispatch.__exit__(None, None, None)
            # On abort the remaining submissions are moot; don't leave the
            # progress surface claiming they are still in flight.
            self.stats.in_flight = 0
            wall = time.perf_counter() - t0
            self.stats.measure_seconds += wall
            cost = self._path_costs.setdefault(path, [0, 0.0])
            cost[0] += self.stats.measured - measured_before
            cost[1] += wall
        return out

    # ---------------------------------------------------------------- internals
    def _submit(self, submit: Callable, sub, label: str):
        """Submit one chunk; rebuild a broken pool once before giving up.

        ``ProcessPoolExecutor.submit`` raises ``BrokenProcessPool`` *at submit*
        once any worker has died abruptly (OOM-kill, segfault).  Executors that
        can recover expose ``respawn()``; one respawn-and-retry turns a single
        worker death into an ordinary chunk retry instead of a lost run.
        Retry timers resubmit concurrently after a pool-wide death, so the
        respawn itself is serialized and late arrivals just resubmit to the
        already-rebuilt pool.
        """
        try:
            return submit(sub)
        except Exception:
            respawn = getattr(self.executor, "respawn", None)
            if respawn is None:
                raise
            with self._respawn_serial:
                try:
                    return submit(sub)  # another thread already respawned
                except Exception:
                    respawn()
                    self._pool_epoch += 1
                    return submit(sub)

    def _quarantine(self, pid: int | None) -> None:
        """Quarantine a repeat offender if the executor supports it."""
        quarantine = getattr(self.executor, "quarantine", None)
        if quarantine is None:
            return
        self.stats.degradation.record("quarantine", pid=pid)
        obs_metrics().inc("runtime.quarantines")
        if get_tracer() is not None:
            instant("runtime.quarantine", {"pid": pid}, cat="runtime")
        with self._respawn_serial:
            quarantine(pid)
            self._pool_epoch += 1
