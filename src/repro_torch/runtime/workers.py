"""Measurement executors: in-process serial and ``concurrent.futures`` pool.

Both expose the same surface the scheduler drives::

    submit(layer_type, batch) -> Future[np.ndarray]    # one config chunk
    submit_blocks(block_batch) -> Future[np.ndarray]   # one block chunk
    close()

:class:`SerialExecutor` measures on the in-process platform object — the
right choice for white-box analytical timing models, whose "measurements" are
cheap array math.  :class:`WorkerPool` fans chunks out across worker
*processes* for real-hardware platforms (XLA-CPU today, GPU/TPU next) whose
measurements hold the GIL or an entire device.

Platforms cannot generally be pickled (jitted closures, device handles), so a
pool worker rebuilds its own instance from the platform's *spawn spec* —
``(registry_name, ctor_kwargs, module)`` from
:meth:`repro_torch.accelerators.base.Platform.spawn_spec`.  The worker imports
``module`` (which registers the platform) and instantiates it through the
registry, without importing the other built-in accelerators; a synthetic
XLA-CPU worker never even imports jax.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import time
import zlib
from concurrent.futures import Future, ProcessPoolExecutor

import numpy as np

from repro_torch.core.batch import BlockBatch, ConfigBatch

#: per-worker-process platform instance, built once by the pool initializer
_WORKER_PLATFORM = None


def _init_worker(spec) -> None:
    """Pool initializer: rebuild the platform from its spawn spec."""
    global _WORKER_PLATFORM
    name, kwargs, module = spec
    if module:
        importlib.import_module(module)
    # Imported here, not at module top: workers resolve the factory
    # registered by `module` through the light top-level registry, without
    # loading the repro_torch.api package or every built-in platform.
    from repro_torch import registry

    factory = registry.try_get_factory(name)
    if factory is not None:
        _WORKER_PLATFORM = factory(**dict(kwargs))
    else:
        _WORKER_PLATFORM = registry.get_platform(name, **dict(kwargs))


def chunk_checksum(y: np.ndarray) -> int:
    """Integrity envelope over a chunk's payload: crc32 of its float64 bytes.

    Computed where the values are produced (the worker) and verified where
    they are merged (the scheduler), so a payload corrupted in transit —
    IPC, pickling, DMA, a fault plan's ``corrupt`` event — is caught by
    checksum mismatch and retried instead of silently breaking bitwise
    reproducibility.
    """
    return zlib.crc32(np.ascontiguousarray(y, dtype=np.float64).tobytes())


def _chunk_meta(w0: float, w1: float, y: np.ndarray) -> dict:
    """Provenance for one measured chunk: which process, over which wall window.

    The parent-side tracer maps the wall-clock window onto its own timeline
    (``Tracer.wall_us``) and emits the chunk as a span on a per-worker track,
    so a Perfetto view of the trace shows pool workers running in parallel.
    Wall clock (``time.time``) is used — unlike ``perf_counter`` its epoch is
    shared across processes.  ``crc`` is the payload's integrity envelope
    (:func:`chunk_checksum`), verified scheduler-side before the merge.
    """
    return {"pid": os.getpid(), "t0": w0, "t1": w1, "crc": chunk_checksum(y)}


def _measure_chunk(
    layer_type: str, params: tuple, values: np.ndarray
) -> tuple[np.ndarray, float, dict]:
    """Worker-side entry point: measure one chunk on the per-process platform.

    Returns ``(times, exec_seconds, meta)`` — ``exec_seconds`` is the chunk's
    execution time measured *worker-side*, around the platform call only.
    Unlike the scheduler's dispatch-loop wall clock it contains no IPC,
    pickling or queue wait, so the scheduler's adaptive chunk sizing gets a
    clean per-item cost signal (see ``effective_chunk_size``).  ``meta`` is
    the chunk's trace provenance (:func:`_chunk_meta`).
    """
    batch = ConfigBatch(params=tuple(params), values=np.asarray(values, dtype=np.int64))
    w0 = time.time()
    t0 = time.perf_counter()
    y = np.asarray(_WORKER_PLATFORM.measure_batch(layer_type, batch), dtype=np.float64)
    return y, time.perf_counter() - t0, _chunk_meta(w0, time.time(), y)


def _measure_block_chunk(batch: BlockBatch) -> tuple[np.ndarray, float, dict]:
    """Worker-side entry point for one block chunk (BlockBatch pickles whole)."""
    w0 = time.time()
    t0 = time.perf_counter()
    y = np.asarray(_WORKER_PLATFORM.measure_block_batch(batch), dtype=np.float64)
    return y, time.perf_counter() - t0, _chunk_meta(w0, time.time(), y)


class SerialExecutor:
    """In-process executor: measures eagerly at submit time.

    Exceptions are captured on the returned future (not raised at submit), so
    the scheduler's retry/failure handling sees both executors identically.
    """

    workers = 1

    def __init__(self, platform) -> None:
        self.platform = platform

    def submit(self, layer_type: str, batch: ConfigBatch) -> Future:
        future: Future = Future()
        try:
            w0 = time.time()
            t0 = time.perf_counter()
            y = np.asarray(
                self.platform.measure_batch(layer_type, batch), dtype=np.float64
            )
            exec_s = time.perf_counter() - t0
            future.set_result((y, exec_s, _chunk_meta(w0, time.time(), y)))
        except Exception as exc:
            future.set_exception(exc)
        return future

    def submit_blocks(self, batch: BlockBatch) -> Future:
        future: Future = Future()
        try:
            w0 = time.time()
            t0 = time.perf_counter()
            y = np.asarray(self.platform.measure_block_batch(batch), dtype=np.float64)
            exec_s = time.perf_counter() - t0
            future.set_result((y, exec_s, _chunk_meta(w0, time.time(), y)))
        except Exception as exc:
            future.set_exception(exc)
        return future

    def close(self) -> None:
        pass


class WorkerPool:
    """``ProcessPoolExecutor`` over platform instances rebuilt from a spawn spec.

    ``mp_context`` defaults to ``"spawn"``: fork is unsafe once device runtimes
    (XLA) are initialized in the parent, and spawn workers re-import only the
    spec's module, keeping them light.
    """

    def __init__(self, spec, workers: int, mp_context: str = "spawn") -> None:
        name, kwargs, module = spec
        self.spec = (name, dict(kwargs), module)
        self.workers = int(workers)
        self.mp_context = mp_context
        self.respawns = 0
        #: pids handed to :meth:`quarantine` (None for anonymous offenders)
        self.quarantined: list[int | None] = []
        self._pool = self._make_pool()

    def _make_pool(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(
            max_workers=self.workers,
            mp_context=multiprocessing.get_context(self.mp_context),
            initializer=_init_worker,
            initargs=(self.spec,),
        )

    def submit(self, layer_type: str, batch: ConfigBatch) -> Future:
        return self._pool.submit(_measure_chunk, layer_type, batch.params, batch.values)

    def submit_blocks(self, batch: BlockBatch) -> Future:
        return self._pool.submit(_measure_block_chunk, batch)

    @staticmethod
    def _shutdown(pool: ProcessPoolExecutor, wait: bool) -> None:
        """Shut a pool down; on non-waiting shutdown, *terminate* survivors.

        ``ProcessPoolExecutor`` workers are non-daemon processes, and
        ``concurrent.futures`` joins them from an atexit hook — so merely
        abandoning a worker wedged inside a measurement (the very thing
        ``chunk_timeout_s`` exists to survive) would hang the campaign
        process at interpreter exit.  Explicit ``terminate()`` makes
        non-waiting close actually abandon them; idle workers just exit.
        """
        procs = list((pool._processes or {}).values())
        pool.shutdown(wait=wait, cancel_futures=True)
        if wait:
            return
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
        for p in procs:
            # SIGTERM can be blocked (native handlers) or deferred by
            # uninterruptible kernel I/O; escalate so the atexit join can
            # never wait on a survivor.
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)

    def respawn(self) -> None:
        """Replace a broken pool (a worker died abruptly) with a fresh one.

        Futures pending on the old pool fail with ``BrokenProcessPool``; the
        scheduler's per-chunk retry resubmits them here.
        """
        self._shutdown(self._pool, wait=False)
        self.respawns += 1
        self._pool = self._make_pool()

    def quarantine(self, pid: int | None = None) -> None:
        """Quarantine a repeat offender: shrink the pool by one slot, respawn.

        ``ProcessPoolExecutor`` cannot evict a single worker, so quarantine
        is pool-level: the replacement pool runs with one slot fewer (never
        below one), which removes the offender *and* stops a sick host from
        re-earning a full-width pool by respawning the same flaky worker.
        Futures in flight on the old pool fail and retry like any respawn.
        """
        self.quarantined.append(pid)
        if self.workers > 1:
            self.workers -= 1
        self._shutdown(self._pool, wait=False)
        self.respawns += 1
        self._pool = self._make_pool()

    def close(self, wait: bool = False) -> None:
        self._shutdown(self._pool, wait=wait)
