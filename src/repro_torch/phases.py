"""Phase recorder: host and device time of the port's serving and training phases.

``phase(name, device)`` is a context manager around one phase of the work
(``serve.prefill``, ``train.backward``, ...).  It is always on:

* it reads ``time.perf_counter`` on entry and exit and observes the host
  time into the ``obs.metrics()`` histogram ``<name>.host_ms``;
* on a CUDA ``device`` it also records a timing-enabled CUDA event pair on
  the current stream (never inside a graph capture: the pair is then left
  out).  Pairs are resolved lazily: when the next outermost phase starts,
  the pairs whose end event is done are observed into ``<name>.device_ms``
  and their events go back to a pool.  ``flush()`` resolves every pending
  pair, waiting for the device if it must; nothing else here ever waits for
  the device;
* with an ``obs`` tracer installed the phase is also an ``obs`` span (its
  ``args`` set with ``set`` after ``if ph:``, as for ``obs.span``), and while
  ``torch.profiler`` records, a ``record_function`` of the same name, so the
  profiler's trace carries the program's phase names.

On the CPU only host times are recorded.  ``allocator_calls(prefix,
device)`` observes the caching allocator's device allocations and frees
(``cudaMalloc`` + ``cudaFree``) since its previous call for ``prefix`` into
``<prefix>.device_allocs``, and its waits on every stream into
``<prefix>.sync_all_streams``.  Phase names are constants at the call sites;
the histogram names are built once per name, here.

Costs on one NVIDIA H100 (``scripts/phase_cost.py``): a phase takes about
1 us of host time, a device pair about 13 (two event records, then one
elapsed-time read that also says whether the pair is done; the driver's
own calls, through ``libcuda``, on the handles of torch's events: torch's
wrappers take twice as long to read one), a reading of the allocator's
counters about 19.  So the call sites time on the device, and read the
allocator, only where a metric needs it.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import metrics as _registry

_perf = time.perf_counter


class _Site:
    """One phase name: its histogram names, built once, its host-time histogram in the current
    registry, and its idle phase objects."""

    __slots__ = ("name", "host", "device", "idle", "_registry", "_host")

    def __init__(self, name: str) -> None:
        self.name = name
        self.host = name + ".host_ms"
        self.device = name + ".device_ms"
        self.idle: list[_Phase] = []
        self._registry = self._host = None

    def host_histogram(self):
        registry = _registry()
        if registry is not self._registry:
            self._registry, self._host = registry, registry.histogram(self.host)
        return self._host


class _Phase:
    """One use of a phase; returned to its site's idle list on exit, so a phase allocates nothing."""

    __slots__ = ("_rec", "_site", "_device", "_tracer", "_span", "_record", "_args", "_stream", "_start",
                 "_t0")

    def __init__(self, rec: "Recorder", site: _Site) -> None:
        self._rec, self._site = rec, site
        self._span = self._record = self._args = self._stream = self._start = None

    def __bool__(self) -> bool:
        """True when an ``obs`` tracer is installed: only then are ``set``'s args kept."""
        return self._tracer is not None

    def set(self, **args) -> "_Phase":
        """Attach span arguments (call it under ``if ph:``; the phase keeps them only when traced)."""
        if self._tracer is not None:
            if self._args is None:
                self._args = {}
            self._args.update(args)
        return self

    def __enter__(self) -> "_Phase":
        rec = self._rec
        if not rec.depth and rec.pending:
            rec.resolve(wait=False)
        if self._tracer is not None:
            self._span = _trace._Span(self._tracer, self._site.name, "phase", None)
            self._span.__enter__()
        if rec.torch.autograd.profiler._is_profiler_enabled:
            self._record = rec.torch.autograd.profiler.record_function(self._site.name)
            self._record.__enter__()
        if self._device is not None:
            events = rec.events
            if not events.capturing():
                self._stream = events.stream(self._device)
                self._start = rec.event()
                events.record(self._start, self._stream)
        rec.depth += 1
        self._t0 = _perf()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = _perf()
        rec, site = self._rec, self._site
        site.host_histogram().observe((t1 - self._t0) * 1e3)
        if self._start is not None:
            end = rec.event()
            rec.events.record(end, self._stream)
            rec.pending.append((site.device, self._start, end, self._stream))
            self._stream = self._start = None
        if self._record is not None:
            self._record.__exit__(exc_type, exc, tb)
            self._record = None
        if self._span is not None:
            if self._args:
                self._span.set(**self._args)
            self._span.__exit__(exc_type, exc, tb)
            self._span = self._args = None
        self._tracer = self._device = None
        rec.depth -= 1
        site.idle.append(self)
        return False


class CudaEvents:
    """Timing events on the card: torch's events, recorded and read through the driver API.

    ``libcuda``'s ``cuEventRecord`` and ``cuEventElapsedTime`` on the raw
    handles of ``torch.cuda.Event`` objects (kept alive in the recorder's
    pool) and of torch's current stream: the elapsed-time read returns
    "not ready" for a pair the device has not reached, so it is also the
    query, and it never raises for that nor leaves an error behind.
    """

    NOT_READY = 600  # CUDA_ERROR_NOT_READY

    def __init__(self, torch) -> None:
        self.torch = torch
        lib = ctypes.CDLL("libcuda.so.1")
        self._record = lib.cuEventRecord
        self._record.argtypes, self._record.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        self._elapsed = lib.cuEventElapsedTime
        self._elapsed.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_void_p]
        self._elapsed.restype = ctypes.c_int
        self._sync = lib.cuEventSynchronize
        self._sync.argtypes, self._sync.restype = [ctypes.c_void_p], ctypes.c_int
        self._ms = ctypes.c_float()
        self._ms_ref = ctypes.byref(self._ms)

    def make(self):
        """A new timing event (its handle exists once torch has recorded it once)."""
        event = self.torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def capturing(self) -> bool:
        return self.torch._C._cuda_isCurrentStreamCapturing()

    def stream(self, device) -> int:
        """The raw handle of ``device``'s current stream."""
        torch = self.torch
        return torch._C._cuda_getCurrentRawStream(device.index if device.index is not None
                                                  else torch._C._cuda_getDevice())

    def record(self, event, stream: int) -> None:
        rc = self._record(event.cuda_event, stream)
        if rc:
            raise RuntimeError(f"cuEventRecord returned CUDA error {rc}")

    def elapsed_ms(self, start, end) -> float | None:
        """Milliseconds from ``start`` to ``end``, or None while the device has not reached ``end``."""
        rc = self._elapsed(self._ms_ref, start.cuda_event, end.cuda_event)
        if rc == self.NOT_READY:
            return None
        if rc:
            raise RuntimeError(f"cuEventElapsedTime returned CUDA error {rc}")
        return self._ms.value

    def wait(self, event) -> None:
        rc = self._sync(event.cuda_event)
        if rc:
            raise RuntimeError(f"cuEventSynchronize returned CUDA error {rc}")


class Recorder:
    """The phases of one process: their sites, the event pool and the pending pairs.

    ``events`` records and reads the device's events (``make``,
    ``capturing``, ``stream``, ``record``, ``elapsed_ms``, ``wait``); the
    default is :class:`CudaEvents`, made at the first device phase.  Tests
    pass a fake one.
    """

    def __init__(self, events=None) -> None:
        self._sites: dict[str, _Site] = {}
        self._events = events
        self._pool: list = []
        self.pending: deque = deque()
        self.depth = 0
        self.torch = None
        self._allocator_names: dict[str, tuple] = {}
        self._lock = threading.Lock()

    def phase(self, name: str, device=None) -> _Phase:
        """The phase ``name``; on a CUDA ``device`` (a ``torch.device``) timed on the device too."""
        site = self._sites.get(name)
        if site is None:
            site = self._sites[name] = _Site(name)
        try:
            ph = site.idle.pop()
        except IndexError:
            ph = _Phase(self, site)
        if self.torch is None:
            import torch

            self.torch = torch
        ph._tracer = _trace._TRACER
        ph._device = device if device is not None and device.type == "cuda" else None
        return ph

    # ------------------------------------------------------------ device side
    @property
    def events(self):
        if self._events is None:
            self._events = CudaEvents(self.torch)
        return self._events

    def event(self):
        try:
            return self._pool.pop()
        except IndexError:
            return self.events.make()

    def allocator_calls(self, prefix: str, device) -> None:
        """Observe the caching allocator's device allocations and frees, and its waits on every
        stream, since the previous call for ``prefix`` (nothing the first time, or off CUDA)."""
        if device.type != "cuda":
            return
        torch = self.torch
        stats = torch._C._cuda_memoryStats(device.index if device.index is not None else torch._C._cuda_getDevice())
        now = (stats["num_device_alloc"] + stats["num_device_free"], stats["num_sync_all_streams"])
        names = self._allocator_names.get(prefix)
        if names is None:
            names = self._allocator_names[prefix] = (prefix + ".device_allocs", prefix + ".sync_all_streams", now)
        else:
            registry = _registry()
            registry.histogram(names[0]).observe(now[0] - names[2][0])
            registry.histogram(names[1]).observe(now[1] - names[2][1])
            self._allocator_names[prefix] = names[:2] + (now,)

    def resolve(self, wait: bool) -> None:
        """Observe the pending pairs that are done (all of them, waiting, with ``wait``), in order.

        A stream runs its work in order, so once a pair is found not done,
        the later pairs of its stream are not looked at."""
        with self._lock:
            pending, registry, events = self.pending, _registry(), self.events
            late: set = set()
            kept = deque()
            while pending:
                item = pending.popleft()
                name, start, end, stream = item
                if stream in late:
                    kept.append(item)
                    continue
                if wait:
                    events.wait(end)
                ms = events.elapsed_ms(start, end)
                if ms is None:
                    late.add(stream)
                    kept.append(item)
                    continue
                registry.histogram(name).observe(ms)
                self._pool.append(start)
                self._pool.append(end)
            pending.extend(kept)

    def flush(self) -> None:
        """Resolve every pending pair, waiting for the device if it must."""
        if self.pending:
            self.resolve(wait=True)


#: the process's recorder: the port's call sites record into it
RECORDER = Recorder()
phase = RECORDER.phase
flush = RECORDER.flush
allocator_calls = RECORDER.allocator_calls


def write_trace(tracer, directory: str, stem: str) -> tuple[str, str]:
    """At a run's end: resolve the pending pairs, then write ``tracer``'s records as
    ``<stem>-<pid>.json`` (Chrome/Perfetto) and a snapshot of ``obs.metrics()`` as
    ``<stem>-<pid>.metrics.json`` into ``directory``; returns both paths."""
    import json
    import os

    flush()
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, f"{stem}-{os.getpid()}")
    tracer.export_chrome(base + ".json")
    with open(base + ".metrics.json", "w", encoding="utf-8") as fh:
        json.dump(_registry().snapshot(), fh, default=str)
    return base + ".json", base + ".metrics.json"


def names() -> frozenset[str]:
    """The phase names this process has entered: a profile's ranges of those names are phases,
    not kernels."""
    return frozenset(RECORDER._sites)


def counter(name: str):
    """The ``obs.metrics()`` counter ``name``."""
    return _registry().counter(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the ``obs.metrics()`` counter ``name``."""
    _registry().counter(name).inc(n)
