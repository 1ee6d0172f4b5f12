"""Keep-alive HTTP connection pool with latency telemetry (counterpart
of ``otedama_tpu/utils/netpool.py``).

The chain's JSON-RPC client (``pool/blockchain.py``) makes repeated calls
to one node: template polls and block submits must not each pay TCP
connect and slow start, and a block submit is the most latency-critical
network write in the system.

Design (standard library only):

- a small per-endpoint pool of ``http.client`` keep-alive connections,
  checked out/in by executor threads (the RPC layer runs blocking IO in
  a thread pool), stale idles dropped by age;
- replay-once on a dead keep-alive, on a FRESH connection with the idle
  list flushed (after a server restart every pooled socket is equally
  dead). Pre-write failures always replay; failures while reading the
  response replay only for calls the caller marked idempotent — see
  ``request()``'s policy note;
- latency EMA + counters per endpoint (reuse hits, opens, errors) so the
  pool's effect is observable (``snapshot()``).
"""

from __future__ import annotations

import http.client
import ssl as ssl_mod
import threading
import time
from urllib.parse import urlparse

DEFAULT_MAX_IDLE = 4
DEFAULT_IDLE_SECONDS = 60.0


class PooledResponse:
    """Fully-read response (the connection goes back to the pool the
    moment the body is consumed)."""

    def __init__(self, status: int, headers, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body


class HttpConnectionPool:
    """Keep-alive pool for ONE endpoint (scheme://host:port)."""

    def __init__(self, url: str, max_idle: int = DEFAULT_MAX_IDLE,
                 idle_seconds: float = DEFAULT_IDLE_SECONDS,
                 timeout: float = 10.0):
        u = urlparse(url)
        self.scheme = u.scheme or "http"
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if self.scheme == "https" else 80)
        self.timeout = timeout
        self.max_idle = max_idle
        self.idle_seconds = idle_seconds
        self._idle: list[tuple[float, http.client.HTTPConnection]] = []
        self._lock = threading.Lock()
        # set by close(): a request still running on an executor thread
        # when the pool closes must not check its connection back in
        self._closed = False
        # telemetry: the whole point of an adaptive pool is a measurable
        # latency win — expose enough to see it
        self.stats = {"requests": 0, "reused": 0, "opened": 0,
                      "retries": 0, "errors": 0}
        self.latency_ema = 0.0  # seconds (alpha 0.2)

    # -- connection lifecycle -------------------------------------------------

    def _new_conn(self) -> http.client.HTTPConnection:
        self.stats["opened"] += 1
        if self.scheme == "https":
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout,
                context=ssl_mod.create_default_context(),
            )
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )

    def _checkout(self) -> tuple[http.client.HTTPConnection, bool]:
        now = time.monotonic()
        with self._lock:
            while self._idle:
                born, conn = self._idle.pop()
                if now - born <= self.idle_seconds:
                    self.stats["reused"] += 1
                    return conn, True
                conn.close()  # stale idle: the server likely reaped it
        return self._new_conn(), False

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append((time.monotonic(), conn))
                return
        conn.close()

    # -- request --------------------------------------------------------------

    def _flush_idle(self) -> None:
        with self._lock:
            for _, conn in self._idle:
                conn.close()
            self._idle.clear()

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None,
                idempotent: bool = False) -> PooledResponse:
        """One request with keep-alive reuse and a single transparent
        replay on a dead idle connection.

        Replay policy: a failure BEFORE the request was fully written
        cannot have reached the server, so it replays whenever the dead
        connection was a reused one. A failure while READING the
        response means the server may already have processed the call —
        that replays only when the caller marked it ``idempotent``
        (e.g. getblocktemplate polls; NOT submitblock, where a replayed
        submit comes back "duplicate" and would mis-report a succeeded
        block as rejected). The replay always runs on a FRESH
        connection with the idle list flushed — after a server restart
        every pooled socket is equally dead.
        """
        self.stats["requests"] += 1
        t0 = time.monotonic()
        for attempt in (0, 1):
            if attempt == 0:
                conn, reused = self._checkout()
            else:
                self._flush_idle()
                conn, reused = self._new_conn(), False
            sent = False
            try:
                conn.request(method, path, body=body,
                             headers=headers or {})
                sent = True
                resp = conn.getresponse()
                data = resp.read()  # drain: required for reuse
                if resp.will_close:
                    # close-delimited response: http.client already shut
                    # the connection down; pooling it would make every
                    # "reuse" a hidden re-dial with lying telemetry
                    conn.close()
                else:
                    self._checkin(conn)
                dt = time.monotonic() - t0
                self.latency_ema = (0.2 * dt + 0.8 * self.latency_ema
                                    if self.latency_ema else dt)
                return PooledResponse(resp.status, resp.headers, data)
            except TimeoutError:
                # a slow server is NOT a dead keep-alive: replaying would
                # silently double the caller's timeout budget
                conn.close()
                self.stats["errors"] += 1
                raise
            except (http.client.BadStatusLine,
                    http.client.CannotSendRequest,
                    OSError):
                # dead connection (reset/EPIPE/EBADF/empty status — the
                # exact shape depends on where the close landed)
                conn.close()
                replayable = (attempt == 0 and reused
                              and (not sent or idempotent))
                if replayable:
                    self.stats["retries"] += 1
                    continue
                self.stats["errors"] += 1
                raise
            except Exception:
                conn.close()
                self.stats["errors"] += 1
                raise
        raise AssertionError("unreachable")  # pragma: no cover

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for _, conn in self._idle:
                conn.close()
            self._idle.clear()

    def snapshot(self) -> dict:
        with self._lock:
            idle = len(self._idle)
        return {**self.stats, "idle": idle,
                "latency_ema_ms": round(self.latency_ema * 1e3, 3)}
