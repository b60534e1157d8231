"""OracleServer: the estimation service behind the serving endpoints.

The paper's economics argument is that a trained PR estimator answers
performance queries "essentially for free" compared to measuring — but only
if queries reach the forest in batches.  ``OracleServer`` is the piece that
makes that true for *concurrent, independent* clients:

* it loads an :class:`repro_torch.api.EstimatorHub` once and keeps warm
  :class:`repro_torch.api.PerfOracle` instances per platform (loading forests is
  the expensive part; queries are cheap);
* every estimation request rides one shared :class:`AdmissionBatcher` —
  concurrent ``predict`` calls for the same ``(layer_type, params)`` group
  become **one** forest pass via :meth:`PerfOracle.predict_many`, concurrent
  ``predict_networks`` / ``autotune`` calls share one
  :meth:`PerfOracle.predict_networks` pass per platform;
* answers are memoised in an LRU :class:`ResultCache` keyed by the same
  canonical identities used for measurement caching (``batch_keys`` for
  layers, :meth:`PerfOracle.network_keys` for networks), so repeat queries
  never touch the forest at all;
* a :class:`MetricsRegistry` records per-endpoint latency percentiles,
  throughput, and the admission batch-size histogram (the direct evidence
  that coalescing happens), exposed through the ``stats`` op.

Coalescing and caching are *bitwise invisible*: forest predictions are
row-independent and cached values are the exact float64 bits the forest
produced, so a served answer is always identical to a direct
``PerfOracle`` call (asserted in tests/test_torch_serving.py).  That
contract is backend-aware: oracles predict with the ``"torch"`` backend on
their device (the card unless ``ServeSpec.device`` is ``"cpu"``) unless
``ServeSpec.predict_backend`` says ``"numpy"``; cache keys stay shared
wherever torch and numpy answers are bitwise-identical, and split
(:meth:`OracleServer._network_key_scope`) for the one combination where they
can differ by a rounding ulp — network predictions whose log-target ``exp``
runs in torch.

The batcher thread runs every coalesced forest pass; a ragged ``predict``
runs on its handler's thread.  Each forest builds its per-device engine (its
tables uploaded to the device) on first use without a lock
(``core/torch_predict.py::_engine``), so two first queries that race can
upload the tables twice; both engines give the same answers, and the last
one stored is kept.

``handle(request) -> response`` speaks plain dicts; the wire framing
(NDJSON over TCP / unix sockets) lives in :mod:`repro_torch.serving.transport`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.api.cache import batch_keys
from repro_torch.api.oracle import PerfOracle
from repro_torch.core.batch import ConfigBatch
from repro_torch.core.blocks import Block
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer, span
from repro_torch.serving.batcher import (
    AdmissionBatcher,
    DeadlineExceeded,
    OverloadError,
    ServingError,
)
from repro_torch.serving.cache import ResultCache
from repro_torch.serving.metrics import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Tuning knobs for one :class:`OracleServer`."""

    #: EstimatorHub directory to load oracles from (None = injected oracles only)
    hub_dir: str | None = None
    #: platforms to load eagerly at startup (others load lazily on first query)
    platforms: tuple[str, ...] = ()
    #: admission window: how long the first request of a batch waits for company
    window_s: float = 0.002
    #: hard cap on requests coalesced into one forest dispatch
    max_batch: int = 4096
    #: LRU result-cache capacity (entries)
    cache_capacity: int = 65536
    #: sliding latency window per endpoint (observations)
    metrics_window: int = 4096
    #: predict backend forced onto every served PerfOracle, "torch" or
    #: "numpy" (None = each oracle's own default, "torch"; see
    #: repro_torch.core.torch_predict).  Applied via dataclasses.replace, so
    #: injected oracle objects are never mutated.
    predict_backend: str | None = None
    #: device the hub's oracles predict on with the "torch" backend: the card
    #: unless this is "cpu" (None = the card; without one a query raises)
    device: str | None = None
    #: admission-queue bound: requests beyond it are answered with an explicit
    #: overload error (``"overloaded": true`` on the wire), never queued
    #: without bound or silently dropped.  None = unbounded.
    max_queue: int | None = 8192
    #: deadline applied to requests that don't carry their own ``deadline_ms``;
    #: None = wait forever (the pre-overload-control behaviour)
    default_deadline_s: float | None = None


def block_payload(block: Block) -> dict:
    """JSON-clean wire form of one :class:`Block` (inverse of :func:`parse_block`)."""
    return {
        "kind": block.kind,
        "layers": [[lt, dict(cfg)] for lt, cfg in block.layers],
        "collective_bytes": block.collective_bytes,
        "repeat": block.repeat,
    }


def parse_block(obj: Any) -> Block:
    """Accept a :class:`Block` (in-process clients) or its wire dict."""
    if isinstance(obj, Block):
        return obj
    if not isinstance(obj, Mapping):
        raise ServingError(f"block must be an object, got {type(obj).__name__}")
    try:
        layers = tuple((str(lt), dict(cfg)) for lt, cfg in obj.get("layers", ()))
        return Block(
            kind=str(obj.get("kind", "block")),
            layers=layers,
            collective_bytes=float(obj.get("collective_bytes", 0.0)),
            repeat=int(obj.get("repeat", 1)),
        )
    except (TypeError, ValueError) as exc:
        raise ServingError(f"malformed block payload: {exc}") from exc


def _require(request: Mapping, field: str) -> Any:
    if field not in request:
        raise ServingError(f"request is missing required field {field!r}")
    return request[field]


class _CoalescedPredictor:
    """``NetworkPredictor`` facade that routes autotune candidates through the
    server's shared network queue — so concurrent autotune and
    predict_networks requests coalesce into the same forest pass and share
    the result cache."""

    def __init__(
        self,
        server: "OracleServer",
        platform: str,
        deadline_s: float | None = None,
    ) -> None:
        self._server = server
        self._platform = platform
        self._deadline_s = deadline_s

    def predict_networks(self, networks: Sequence[Sequence[Block]]) -> np.ndarray:
        values = self._server._network_values(
            self._platform,
            [list(net) for net in networks],
            deadline_s=self._deadline_s,
        )
        return np.asarray(values, dtype=np.float64)

    def predict_network(self, blocks: Sequence[Block]) -> float:
        return float(self.predict_networks([blocks])[0])


class OracleServer:
    """Coalescing, caching, metered front-end over per-platform ``PerfOracle``s."""

    def __init__(
        self,
        hub=None,
        oracles: Mapping[str, PerfOracle] | None = None,
        spec: ServeSpec = ServeSpec(),
    ) -> None:
        if hub is None and spec.hub_dir:
            from repro_torch.api.hub import EstimatorHub

            hub = EstimatorHub(spec.hub_dir)
        self.hub = hub
        self.spec = spec
        self._oracles: dict[str, PerfOracle] = dict(oracles or {})
        self._oracle_lock = threading.Lock()
        self.cache = ResultCache(capacity=spec.cache_capacity)
        self.metrics = MetricsRegistry(window=spec.metrics_window)
        # Hit/miss/eviction accounting with zero hot-path cost: the gauge
        # pulls ResultCache.stats() only when someone snapshots the metrics.
        self.metrics.register_gauge("result_cache", self.cache.stats)
        self.batcher = AdmissionBatcher(
            self._process,
            window_s=spec.window_s,
            max_batch=spec.max_batch,
            on_batch=self.metrics.observe_batch,
            max_queue=spec.max_queue,
        )
        # Graceful drain: `handle` registers in-flight requests under this
        # condition; `drain()` flips `_draining` (new requests get an explicit
        # "draining" response) and waits for the in-flight count to hit zero,
        # so every admitted waiter is answered before the socket closes.
        self._drain_cond = threading.Condition()
        self._inflight = 0
        self._draining = False
        self._started_at = time.perf_counter()
        self._handlers = {
            "ping": self._op_ping,
            "predict": self._op_predict,
            "predict_networks": self._op_predict_networks,
            "autotune": self._op_autotune,
            "stats": self._op_stats,
            "platforms": self._op_platforms,
            "warm": self._op_warm,
            "gc": self._op_gc,
        }
        # Precomputed span labels: formatting f"serve.{op}" per request would
        # allocate on the disabled-tracing fast path (obs-zero-overhead).
        self._span_names = {op: f"serve.{op}" for op in self._handlers}
        if spec.platforms:
            self.warm(*spec.platforms)

    # ------------------------------------------------------------- oracles
    def platforms(self) -> dict:
        hub_platforms = sorted(self.hub.platforms()) if self.hub is not None else []
        return {"loaded": sorted(self._oracles), "hub": hub_platforms}

    def warm(self, *platforms: str) -> None:
        """Load (and keep) the named platforms' oracles now, not on first query."""
        for p in platforms:
            self._oracle(p)

    def _oracle(self, platform: str) -> PerfOracle:
        with self._oracle_lock:
            oracle = self._oracles.get(platform)
            if oracle is None:
                if self.hub is None:
                    raise ServingError(
                        f"unknown platform {platform!r}; loaded: "
                        f"{sorted(self._oracles)} (no hub attached)"
                    )
                try:
                    # repro-lint: disable=lock-blocking -- cold-start loads are
                    # deliberately serialized: concurrent first queries for a
                    # platform must collapse into one estimator load, not race
                    # N duplicate ones; warm() exists to pay this up front
                    oracle = PerfOracle.load(self.hub, platform, device=self.spec.device)
                except FileNotFoundError as exc:
                    raise ServingError(str(exc)) from exc
                self._oracles[platform] = oracle
            if (
                self.spec.predict_backend is not None
                and isinstance(oracle, PerfOracle)
                and oracle.predict_backend != self.spec.predict_backend
            ):
                # Copy-on-apply: the injected/loaded oracle object stays
                # untouched; the served copy keeps its device and shares
                # forests (and their warm device engines) by reference.
                oracle = dataclasses.replace(
                    oracle, predict_backend=self.spec.predict_backend
                )
                self._oracles[platform] = oracle
            return oracle

    # ----------------------------------------------------- batched dispatch
    def _process(self, payloads: Sequence[tuple]) -> list:
        """Admission-batch processor: one forest dispatch per platform/group.

        Runs on the batcher thread.  Layer payloads ``("layers", platform,
        layer_type, ConfigBatch)`` group per platform through
        :meth:`PerfOracle.predict_many`; network payloads ``("networks",
        platform, [networks])`` concatenate per platform through one
        :meth:`PerfOracle.predict_networks` pass.  A failing group poisons
        only its own waiters (results may be Exception instances).
        """
        dispatch = span("serve.coalesce", cat="serving")
        if dispatch:
            dispatch.set(payloads=len(payloads))
        with dispatch:
            return self._process_batch(payloads)

    def _process_batch(self, payloads: Sequence[tuple]) -> list:
        out: list = [None] * len(payloads)
        layer_groups: dict[str, list[tuple[int, str, ConfigBatch]]] = {}
        net_groups: dict[str, list[tuple[int, list]]] = {}
        for i, payload in enumerate(payloads):
            if payload[0] == "layers":
                layer_groups.setdefault(payload[1], []).append(
                    (i, payload[2], payload[3])
                )
            else:
                net_groups.setdefault(payload[1], []).append((i, payload[2]))
        for platform, items in layer_groups.items():
            try:
                oracle = self._oracle(platform)
                ys = oracle.predict_many([(lt, b) for _, lt, b in items])
            except Exception as exc:  # noqa: BLE001 - per-group fan-out
                for i, _, _ in items:
                    out[i] = exc
                continue
            for (i, _, _), y in zip(items, ys):
                out[i] = y
        for platform, items in net_groups.items():
            try:
                oracle = self._oracle(platform)
                flat = [net for _, nets in items for net in nets]
                y = oracle.predict_networks(flat)
            except Exception as exc:  # noqa: BLE001 - per-group fan-out
                for i, _ in items:
                    out[i] = exc
                continue
            a = 0
            for i, nets in items:
                out[i] = y[a : a + len(nets)]
                a += len(nets)
        return out

    # -------------------------------------------------------- value helpers
    def _predict_values(
        self,
        platform: str,
        layer_type: str,
        configs: Sequence[Mapping],
        deadline_s: float | None = None,
    ) -> list[float]:
        oracle = self._oracle(platform)
        if layer_type not in oracle.layer_types():
            raise ServingError(
                f"platform {platform!r} has no estimator for layer type "
                f"{layer_type!r}; available: {sorted(oracle.layer_types())}"
            )
        configs = list(configs)
        if not configs:
            return []
        try:
            batch = ConfigBatch.from_dicts(configs)
            keys: list = [(platform,) + k for k in batch_keys(layer_type, batch)]
        except (ValueError, TypeError):
            # Ragged / non-integer configs can't be columnarised or keyed:
            # predict directly (identical answers), skip cache and coalescing.
            return [float(v) for v in oracle.predict(layer_type, configs)]
        cached = self.cache.get_many(keys)
        miss = [i for i, v in enumerate(cached) if v is None]
        if miss:
            if len(miss) == len(cached):  # all-miss (the cold-cache common case)
                sub = batch
            else:
                sub = batch.take(np.asarray(miss, dtype=np.int64))
            y = self.batcher.submit(
                ("layers", platform, layer_type, sub), deadline_s=deadline_s
            )
            self.cache.put_many([keys[i] for i in miss], y)
            for i, yi in zip(miss, y):
                cached[i] = float(yi)
        return cached  # type: ignore[return-value]

    @staticmethod
    def _network_key_scope(oracle) -> tuple:
        """Cache-key scope distinguishing backends whose answers can differ.

        Cache hits must be byte-identical to a direct oracle call, so a key
        may be shared across backends only where parity is bitwise.  Layer
        predictions always are (the forest traversal is bitwise and the
        log-target ``exp`` runs in numpy on both backends), so layer keys are
        never scoped.  Network predictions are bitwise except when the torch
        backend runs a log-target ``exp`` inside the network call (rtol
        1e-12) — only that combination gets its own key space.
        """
        from repro_torch.core.estimator import LayerEstimator
        from repro_torch.core.torch_predict import resolve_backend

        backend = getattr(oracle, "predict_backend", None)
        if resolve_backend(backend, getattr(oracle, "device", None)) == "numpy":
            return ()
        estimators = getattr(oracle, "estimators", {})
        if any(
            est.log_target
            for est in estimators.values()
            if isinstance(est, LayerEstimator)
        ):
            return ("torch",)
        return ()

    def _network_values(
        self,
        platform: str,
        nets: list[list[Block]],
        deadline_s: float | None = None,
    ) -> list[float]:
        oracle = self._oracle(platform)
        if not nets:
            return []
        scope = self._network_key_scope(oracle)
        net_keys = oracle.network_keys(nets)
        keys = [None if k is None else (platform, *scope) + k for k in net_keys]
        cached = self.cache.get_many(keys)
        miss = [i for i, v in enumerate(cached) if v is None]
        if miss:
            sub = nets if len(miss) == len(cached) else [nets[i] for i in miss]
            y = self.batcher.submit(("networks", platform, sub), deadline_s=deadline_s)
            self.cache.put_many([keys[i] for i in miss], y)
            for i, yi in zip(miss, y):
                cached[i] = float(yi)
        return cached  # type: ignore[return-value]

    # ------------------------------------------------------------ endpoints
    def _deadline_s(self, request: Mapping) -> float | None:
        """Per-request deadline: ``deadline_ms`` on the wire, else the spec's."""
        raw = request.get("deadline_ms")
        if raw is None:
            return self.spec.default_deadline_s
        try:
            deadline_ms = float(raw)
        except (TypeError, ValueError) as exc:
            raise ServingError(f"'deadline_ms' must be a number, got {raw!r}") from exc
        if deadline_ms <= 0:
            raise ServingError("'deadline_ms' must be positive")
        return deadline_ms / 1000.0

    def _op_ping(self, request: Mapping) -> tuple[Any, int]:
        return {"pong": True}, 1

    def _op_predict(self, request: Mapping) -> tuple[Any, int]:
        platform = _require(request, "platform")
        layer_type = _require(request, "layer_type")
        configs = _require(request, "configs")
        if not isinstance(configs, Sequence) or isinstance(configs, (str, bytes)):
            raise ServingError("'configs' must be a list of config objects")
        values = self._predict_values(
            platform, layer_type, configs, deadline_s=self._deadline_s(request)
        )
        return values, len(values)

    def _op_predict_networks(self, request: Mapping) -> tuple[Any, int]:
        platform = _require(request, "platform")
        networks = _require(request, "networks")
        if not isinstance(networks, Sequence) or isinstance(networks, (str, bytes)):
            raise ServingError("'networks' must be a list of block lists")
        nets = [[parse_block(b) for b in net] for net in networks]
        values = self._network_values(
            platform, nets, deadline_s=self._deadline_s(request)
        )
        return values, len(values)

    def _op_autotune(self, request: Mapping) -> tuple[Any, int]:
        from repro_torch.configs import get_config
        from repro_torch.core.advisor import Candidate, autotune
        from repro_torch.models.config import InputShape, reduced

        platform = _require(request, "platform")
        arch = _require(request, "arch")
        try:
            cfg = get_config(arch)
        except KeyError as exc:
            raise ServingError(str(exc)) from exc
        if request.get("reduced"):
            cfg = reduced(cfg)
        shape = InputShape(
            name=str(request.get("shape_name", "serve")),
            seq_len=int(request.get("seq_len", 4096)),
            global_batch=int(request.get("batch", 8)),
            kind=request.get("kind", "decode"),
        )
        raw = request.get("candidates")
        candidates = None
        if raw is not None:
            candidates = [
                Candidate(
                    dp=int(c["dp"]),
                    tp=int(c["tp"]),
                    microbatches=int(c.get("microbatches", 1)),
                )
                for c in raw
            ]
        predictor = _CoalescedPredictor(
            self, platform, deadline_s=self._deadline_s(request)
        )
        ranked = autotune(
            predictor, cfg, shape, candidates=candidates,
            chips=int(request.get("chips", 256)),
        )
        result = [
            {
                "dp": c.dp,
                "tp": c.tp,
                "microbatches": c.microbatches,
                "seconds": s if math.isfinite(s) else None,
            }
            for c, s in ranked
        ]
        return result, len(result)

    def _op_stats(self, request: Mapping) -> tuple[Any, int]:
        tracer = get_tracer()
        return {
            "uptime_s": time.perf_counter() - self._started_at,
            "platforms": self.platforms(),
            "result_cache": self.cache.stats(),
            "metrics": self.metrics.snapshot(),
            # Process-wide observability: pipeline counters/gauges/histograms
            # (torch forest calls, journal corruption, runtime retries) plus
            # where the active trace, if any, is being written.
            "obs": {
                "pid": os.getpid(),
                "process_metrics": obs_metrics().snapshot(),
                "trace_path": getattr(tracer, "path", None),
                "trace_events": getattr(tracer, "events_written", 0),
            },
        }, 1

    def _op_platforms(self, request: Mapping) -> tuple[Any, int]:
        return self.platforms(), 1

    def _op_warm(self, request: Mapping) -> tuple[Any, int]:
        platform = _require(request, "platform")
        oracle = self._oracle(platform)
        return {"platform": platform, "layer_types": sorted(oracle.layer_types())}, 1

    def _op_gc(self, request: Mapping) -> tuple[Any, int]:
        if self.hub is None:
            raise ServingError("no hub attached; nothing to gc")
        return self.hub.gc(), 1

    # -------------------------------------------------------------- request
    def handle(self, request: Any) -> dict:
        """Answer one request dict; errors come back as responses, never raise.

        A malformed or failing request yields ``{"ok": False, "error": ...}``
        (and an error count in the metrics) — it must not take the server
        down with it (asserted in tests/test_serving.py).  Overload and
        deadline failures additionally carry a machine-readable flag
        (``"overloaded"`` / ``"deadline_exceeded"``) so clients can back off
        or give up without parsing error strings; a draining server answers
        with ``"draining"`` instead of accepting work it may not finish.
        """
        rid = request.get("id") if isinstance(request, Mapping) else None
        op = request.get("op") if isinstance(request, Mapping) else None
        with self._drain_cond:
            if self._draining:
                return {
                    "id": rid,
                    "ok": False,
                    "draining": True,
                    "error": "ServingError: server is draining",
                }
            self._inflight += 1
        try:
            return self._handle_admitted(request, rid, op)
        finally:
            with self._drain_cond:
                self._inflight -= 1
                if self._inflight == 0:
                    self._drain_cond.notify_all()

    def _handle_admitted(self, request: Any, rid: Any, op: Any) -> dict:
        t0 = time.perf_counter()
        try:
            if not isinstance(request, Mapping):
                raise ServingError(
                    f"request must be a JSON object, got {type(request).__name__}"
                )
            handler = self._handlers.get(op)
            if handler is None:
                raise ServingError(
                    f"unknown op {op!r}; available: {sorted(self._handlers)}"
                )
            with span(self._span_names[op], cat="serving"):
                result, items = handler(request)
        except Exception as exc:  # noqa: BLE001 - error becomes the response
            self.metrics.observe(
                str(op) if op else "invalid",
                time.perf_counter() - t0, items=0, error=True,
            )
            response = {
                "id": rid, "ok": False, "error": f"{type(exc).__name__}: {exc}",
            }
            if isinstance(exc, OverloadError):
                response["overloaded"] = True
                obs_metrics().inc("serve.overload")
            elif isinstance(exc, DeadlineExceeded):
                response["deadline_exceeded"] = True
                obs_metrics().inc("serve.deadline_exceeded")
            return response
        self.metrics.observe(str(op), time.perf_counter() - t0, items=items)
        return {"id": rid, "ok": True, "result": result}

    # ------------------------------------------------------------ lifecycle
    def drain(self, timeout_s: float | None = None) -> bool:
        """Stop admitting requests and wait for in-flight ones to be answered.

        Returns True once the in-flight count reaches zero (False on
        timeout).  Idempotent; new ``handle`` calls after drain starts get an
        explicit ``"draining"`` response rather than silently vanishing.
        """
        deadline = None if timeout_s is None else time.perf_counter() + timeout_s
        with self._drain_cond:
            self._draining = True
            while self._inflight > 0:
                remaining = (
                    None if deadline is None else deadline - time.perf_counter()
                )
                if remaining is not None and remaining <= 0:
                    return False
                # repro-lint: disable=lock-blocking -- condition-variable wait
                # releases the lock; this *is* the drain barrier
                self._drain_cond.wait(timeout=remaining)
            return self._inflight == 0

    def close(self, drain_s: float | None = 5.0) -> None:
        """Drain in-flight requests (bounded by ``drain_s``), then stop.

        Every waiter admitted before close is answered — the batcher is only
        torn down after the drain barrier, so no request blocked inside
        ``batcher.submit`` can be abandoned mid-wait.
        """
        self.drain(timeout_s=drain_s)
        self.batcher.close()

    def __enter__(self) -> "OracleServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
