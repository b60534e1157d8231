"""Wire transport for the oracle server: NDJSON over TCP / unix sockets.

The protocol is deliberately minimal — one JSON object per line in each
direction, UTF-8, ``\\n``-terminated (line-delimited JSON):

    -> {"id": 1, "op": "predict", "platform": "...", "layer_type": "...",
        "configs": [{"a": 8, "b": 4}, ...]}
    <- {"id": 1, "ok": true, "result": [1.25e-05, ...]}

Requests on one connection are answered in order; concurrency comes from
opening multiple connections (one handler thread each), whose in-flight
requests the server coalesces into shared forest passes.  Errors — malformed
JSON, unknown ops, bad payloads — are *responses* (``ok: false`` with an
``error`` string), never connection resets: a broken client cannot take the
server down (asserted in tests/test_serving.py).

Floats survive the wire bitwise: ``json.dumps``/``loads`` round-trip IEEE-754
doubles exactly (``repr``-based shortest-round-trip formatting), so a served
answer equals the direct ``PerfOracle`` call to the last bit.  Non-finite
scores (infeasible autotune candidates) are mapped to ``null`` server-side so
the stream stays strict-JSON-clean.

``OracleClient`` fronts both modes with the same API: in-process (wrap an
``OracleServer`` directly — same dict pipeline, no sockets) and remote
(TCP address or unix-socket path).
"""

from __future__ import annotations

import json
import os
import random
import socket
import socketserver
import threading
import time
from typing import Any, Mapping, Sequence

from repro_torch.serving.batcher import ServingError
from repro_torch.serving.server import OracleServer, block_payload


def _encode(obj: Any) -> bytes:
    # allow_nan=False: non-JSON tokens (NaN/Infinity) would break strict
    # parsers; the server maps non-finite values to None before this point.
    return json.dumps(obj, allow_nan=False, separators=(",", ":")).encode() + b"\n"


class _RequestHandler(socketserver.StreamRequestHandler):
    """One thread per connection; requests answered in arrival order."""

    def handle(self) -> None:
        while True:
            try:
                line = self.rfile.readline()
            except (ConnectionError, OSError):
                return
            if not line:
                return  # client closed
            line = line.strip()
            if not line:
                continue
            try:
                request = json.loads(line)
            except json.JSONDecodeError as exc:
                response = {"id": None, "ok": False, "error": f"malformed JSON: {exc}"}
            else:
                if getattr(self.server.oracle_server, "_draining", False):
                    # Shutting down: close instead of answering, so the
                    # client's reconnect-once finds the restarted server
                    # (requests admitted before the drain are still answered
                    # through the barrier in OracleServer.close).
                    return
                response = self.server.oracle_server.handle(request)
            try:
                self.wfile.write(_encode(response))
                self.wfile.flush()
            except (ConnectionError, OSError):
                return


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


if hasattr(socketserver, "ThreadingUnixStreamServer"):

    class _ThreadingUnixServer(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

else:  # non-POSIX fallback: unix sockets unavailable
    _ThreadingUnixServer = None  # type: ignore[assignment]


class OracleSocketServer:
    """Socket front-end for one :class:`OracleServer` (TCP or unix socket)."""

    def __init__(
        self,
        server: OracleServer,
        host: str = "127.0.0.1",
        port: int = 0,
        unix_socket: str | None = None,
    ) -> None:
        self.oracle_server = server
        self.unix_socket = unix_socket
        if unix_socket is not None:
            if _ThreadingUnixServer is None:
                raise ServingError("unix sockets are not supported on this platform")
            if os.path.exists(unix_socket):
                os.unlink(unix_socket)  # stale socket from a previous run
            self._sock_server = _ThreadingUnixServer(unix_socket, _RequestHandler)
        else:
            self._sock_server = _ThreadingTCPServer((host, port), _RequestHandler)
        self._sock_server.oracle_server = server  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def address(self):
        """Connectable address: ``(host, port)`` for TCP, path for unix."""
        if self.unix_socket is not None:
            return self.unix_socket
        host, port = self._sock_server.server_address[:2]
        return (host, port)

    def start(self) -> "OracleSocketServer":
        """Serve in a daemon thread (tests, benchmarks, in-process use)."""
        self._thread = threading.Thread(
            target=self._sock_server.serve_forever,
            name="oracle-socket-server",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread (the ``--serve-oracle`` launcher)."""
        self._sock_server.serve_forever()

    def close(self, drain_s: float | None = 5.0) -> None:
        """Graceful shutdown: stop accepting, drain, then tear down.

        Order matters: ``shutdown()`` stops the accept loop first, the oracle
        server then drains (answering every in-flight waiter, bounded by
        ``drain_s``), and only after that is the listening socket closed —
        so a request admitted before close always gets its response line.
        """
        self._sock_server.shutdown()
        self.oracle_server.close(drain_s=drain_s)
        self._sock_server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self.unix_socket is not None and os.path.exists(self.unix_socket):
            try:
                os.unlink(self.unix_socket)
            except OSError:
                pass

    def __enter__(self) -> "OracleSocketServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class OracleClient:
    """Uniform client API over in-process and socket transports.

    Exactly one of ``server`` / ``address`` / ``path``:

    * ``OracleClient(server=srv)`` — in-process: requests go straight into
      ``srv.handle`` (still coalesced/cached/metered; no sockets involved);
    * ``OracleClient(address=(host, port))`` — TCP;
    * ``OracleClient(path="/tmp/oracle.sock")`` — unix socket.

    Socket clients hold one connection and serialize their own requests on a
    lock; use one client per thread for concurrency (the server coalesces
    across connections).  A dropped or reset connection (server restart,
    idle-timeout close) is retried **once** after a jittered backoff by
    transparently reconnecting and resending the request — safe because every
    op is idempotent (predictions are pure, ``warm``/``gc`` converge).  A
    request that *times out* is never resent: the server may still be working
    on it, and resending would double the wait.
    """

    def __init__(
        self,
        server: OracleServer | None = None,
        address: tuple[str, int] | None = None,
        path: str | None = None,
        timeout: float | None = 60.0,
    ) -> None:
        given = [x is not None for x in (server, address, path)]
        if sum(given) != 1:
            raise ValueError("pass exactly one of server=, address=, path=")
        self._server = server
        self._address = address
        self._path = path
        self._timeout = timeout
        self._lock = threading.Lock()
        self._next_id = 0
        self._sock = None
        self._rfile = self._wfile = None
        if server is None:
            self._connect_locked()

    # ------------------------------------------------------------- plumbing
    def _connect_locked(self) -> None:
        """(Re)build the socket + file pair; caller holds the lock (or init)."""
        if self._address is not None:
            self._sock = socket.create_connection(
                self._address, timeout=self._timeout
            )
        else:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(self._timeout)
            self._sock.connect(self._path)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")

    def _reconnect_locked(self, cause: BaseException) -> None:
        """One reconnect attempt after a dropped connection (lock held).

        Raises :class:`ServingError` (never a raw ``OSError``) when the
        endpoint stays down.
        """
        for f in (self._rfile, self._wfile):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        # Jittered so a fleet of clients dropped by one server restart does
        # not stampede back in lockstep.
        # repro-lint: disable=lock-blocking -- the backoff must serialize with
        # the request pipeline: releasing the lock here would let another
        # caller interleave a request onto a half-rebuilt connection
        time.sleep(0.05 * (1.0 + random.random()))
        try:
            self._connect_locked()
        except OSError as exc:
            raise ServingError(
                f"connection lost ({cause}) and reconnect failed: {exc}"
            ) from exc

    def _roundtrip_locked(self, data: bytes) -> bytes:
        self._wfile.write(data)
        self._wfile.flush()
        # repro-lint: disable=lock-blocking -- the lock *is* the
        # request pipeline: NDJSON responses carry no ids on the wire
        # beyond echo, so one in-flight request per connection is the
        # protocol; concurrent callers should use one client each (or
        # the in-process path above, which coalesces)
        return self._rfile.readline()

    def _call(self, request: dict) -> Any:
        with self._lock:
            self._next_id += 1
            rid = self._next_id
        request = {"id": rid, **request}
        if self._server is not None:
            # In-process: no connection to protect — concurrent callers go
            # straight into handle() so the admission batcher can coalesce them.
            response = self._server.handle(request)
        else:
            data = _encode(request)
            with self._lock:
                if self._sock is None:
                    raise ServingError("client is closed")
                try:
                    line = self._roundtrip_locked(data)
                    if not line:
                        # EOF mid-protocol == the connection dropped; eligible
                        # for the same single reconnect as a reset.
                        raise ConnectionResetError("server closed the connection")
                except TimeoutError as exc:
                    raise ServingError(f"request timed out: {exc}") from exc
                except (ConnectionError, OSError) as exc:
                    self._reconnect_locked(exc)
                    try:
                        line = self._roundtrip_locked(data)
                    except OSError as retry_exc:
                        raise ServingError(
                            f"request failed after reconnect: {retry_exc}"
                        ) from retry_exc
                    if not line:
                        raise ServingError("server closed the connection") from exc
            response = json.loads(line)
        if not isinstance(response, Mapping) or "ok" not in response:
            raise ServingError(f"malformed response: {response!r}")
        if not response["ok"]:
            raise ServingError(str(response.get("error", "unknown server error")))
        return response.get("result")

    # ------------------------------------------------------------------ api
    def ping(self) -> bool:
        return bool(self._call({"op": "ping"})["pong"])

    def predict(
        self, platform: str, layer_type: str, configs: Sequence[Mapping]
    ) -> list[float]:
        return self._call(
            {
                "op": "predict",
                "platform": platform,
                "layer_type": layer_type,
                "configs": [dict(c) for c in configs],
            }
        )

    def predict_one(self, platform: str, layer_type: str, cfg: Mapping) -> float:
        return float(self.predict(platform, layer_type, [cfg])[0])

    def predict_networks(self, platform: str, networks: Sequence[Sequence]) -> list[float]:
        payload = [
            [b if isinstance(b, Mapping) else block_payload(b) for b in net]
            for net in networks
        ]
        return self._call(
            {"op": "predict_networks", "platform": platform, "networks": payload}
        )

    def predict_network(self, platform: str, blocks: Sequence) -> float:
        return float(self.predict_networks(platform, [blocks])[0])

    def autotune(self, platform: str, arch: str, **kwargs) -> list[dict]:
        return self._call(
            {"op": "autotune", "platform": platform, "arch": arch, **kwargs}
        )

    def stats(self) -> dict:
        return self._call({"op": "stats"})

    def platforms(self) -> dict:
        return self._call({"op": "platforms"})

    def warm(self, platform: str) -> dict:
        return self._call({"op": "warm", "platform": platform})

    def gc(self) -> dict:
        return self._call({"op": "gc"})

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        # Under the connection lock: a close racing an in-flight _call must
        # not yank the socket out from under the write/readline pair.
        with self._lock:
            if self._sock is not None:
                for f in (self._rfile, self._wfile):
                    try:
                        f.close()
                    except OSError:
                        pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def __enter__(self) -> "OracleClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
