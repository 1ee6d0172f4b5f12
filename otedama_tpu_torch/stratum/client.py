"""Asyncio stratum V1 client (counterpart of
``otedama_tpu/stratum/client.py``, copied whole).

Reference parity: internal/stratum/unified_stratum.go:189-515 — connect,
subscribe (:370), authorize (:380), notification handlers (:433-512:
mining.notify / mining.set_difficulty / mining.set_extranonce /
client.reconnect), submit pipeline (:327-341,397-417), reconnect with
backoff (internal/network/auto_reconnect.go). Redesigned for asyncio: one
reader task demultiplexes responses to pending futures (the reference fires
and forgets submits; we await the pool's accept/reject verdict so the engine
can track accept latency — BASELINE config 4's metric).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Awaitable, Callable

from otedama_tpu_torch.engine.types import Job, Share
from otedama_tpu_torch.stratum import protocol as sp
from otedama_tpu_torch.utils import faults

log = logging.getLogger("otedama.stratum.client")

JobCallback = Callable[[Job], None]
DifficultyCallback = Callable[[float], None]


@dataclasses.dataclass
class ClientConfig:
    host: str = "127.0.0.1"
    port: int = 3333
    username: str = "wallet.worker"       # wallet.worker_name
    password: str = "x"
    user_agent: str = "otedama-tpu/0.1"
    algorithm: str = "sha256d"
    response_timeout: float = 10.0
    reconnect_initial: float = 1.0
    reconnect_max: float = 60.0
    keepalive_seconds: float = 0.0        # 0 = disabled


@dataclasses.dataclass
class SubmitResult:
    accepted: bool
    error: list | None
    latency: float  # seconds from write to pool verdict


# histogram upper bounds bracketing the reference's 50 ms target
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0
)

# a session that survived at least this long before dying counts as a
# FRESH failure (reconnect backoff restarts); shorter-lived sessions
# keep climbing the ladder so a pool that crash-loops seconds after
# authorize still sees exponential backoff, not a reconnect storm
BACKOFF_RESET_AFTER = 30.0


class StratumClient:
    """One upstream pool connection."""

    def __init__(
        self,
        config: ClientConfig,
        on_job: JobCallback | None = None,
        on_difficulty: DifficultyCallback | None = None,
    ):
        self.config = config
        self.on_job = on_job
        self.on_difficulty = on_difficulty
        self.extranonce1 = b""
        self.extranonce2_size = 4
        self.difficulty = 1.0
        self.current_job: Job | None = None
        self.connected = asyncio.Event()
        # signed session resume token (stratum/resume.py): captured from
        # the subscribe result / set_resume_token notifications, presented
        # as the 2nd subscribe param on every reconnect so ANY region of
        # the pool recovers this session's extranonce1 + difficulty. The
        # app's failover path carries it onto replacement clients.
        self.resume_token = ""
        self.stats = {
            "shares_submitted": 0,
            "shares_accepted": 0,
            "shares_rejected": 0,
            "reconnects": 0,
            "resumes_sent": 0,
            "last_accept_latency": 0.0,
        }
        # share-accept latency distribution (BASELINE config 4; the
        # reference targets <50 ms, README.md:104): cumulative counts per
        # upper bound, exported as otedama_share_latency_seconds
        self.latency_buckets: dict[float, int] = {
            le: 0 for le in LATENCY_BUCKETS
        }
        self.latency_sum = 0.0
        self.latency_count = 0
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 3  # 1=subscribe, 2=authorize
        self._tasks: list[asyncio.Task] = []
        self._stop = False
        self._reconnect_requested = False
        self._established = False   # this connection fully subscribed
        self._established_at = 0.0
        # chaos runs target one upstream among several by this tag
        self._fault_tag = f"{config.host}:{config.port}"

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Connect and keep the session alive (reconnects on failure)."""
        self._stop = False
        self._tasks.append(asyncio.create_task(self._session_loop()))
        await self.connected.wait()

    async def stop(self) -> None:
        self._stop = True
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        await self._close()

    async def _close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass
        self._reader = self._writer = None
        self.connected.clear()
        for fut in self._pending.values():
            if not fut.done():
                # a real exception, not cancel(): wait_for also cancels the
                # future when the *caller's* task is cancelled, so cancel()
                # would make internal closure indistinguishable from external
                # cancellation at the await site
                fut.set_exception(ConnectionError("connection closed"))
        self._pending.clear()

    async def _session_loop(self) -> None:
        backoff = self.config.reconnect_initial
        last_target: tuple[str, int] | None = None
        while not self._stop:
            self._established = False
            try:
                await self._connect_and_run()
                backoff = self.config.reconnect_initial
            except asyncio.CancelledError:
                return
            except Exception as e:
                log.warning("session error: %s", e)
            await self._close()
            if self._stop:
                return
            self.stats["reconnects"] += 1
            # the ladder restarts for FRESH failures only: a re-pointed
            # destination (failover / region handoff — a handoff must
            # land in milliseconds, and the old ladder doubled across
            # the client's whole lifetime because _connect_and_run only
            # returns on cancel) or a session that lived long enough to
            # prove the failure streak over. A pool that crash-loops
            # seconds after authorize keeps climbing it.
            target = (self.config.host, self.config.port)
            long_lived = (
                self._established
                and time.monotonic() - self._established_at
                >= min(BACKOFF_RESET_AFTER, self.config.reconnect_max)
            )
            if long_lived or target != last_target:
                backoff = self.config.reconnect_initial
            last_target = target
            delay = 0.1 if self._reconnect_requested else backoff
            self._reconnect_requested = False
            await asyncio.sleep(delay)
            backoff = min(backoff * 2, self.config.reconnect_max)

    async def _connect_and_run(self) -> None:
        cfg = self.config
        log.info("connecting to %s:%d", cfg.host, cfg.port)
        self._reader, self._writer = await asyncio.open_connection(cfg.host, cfg.port)
        params = [cfg.user_agent]
        if self.resume_token:
            # classic stratum's "previous session id" slot: a reconnect
            # (to this pool OR a sibling region) resumes rather than
            # resetting difficulty/extranonce state
            params.append(self.resume_token)
            self.stats["resumes_sent"] += 1
        sub = await self._call("mining.subscribe", params)
        # result: [[[notify_sub, id], ...], extranonce1, extranonce2_size,
        #          resume_token?]
        if not isinstance(sub, list) or len(sub) < 3:
            raise sp.StratumError(sp.ERR_OTHER, f"bad subscribe result: {sub!r}")
        self.extranonce1 = bytes.fromhex(sub[1])
        self.extranonce2_size = int(sub[2])
        if len(sub) > 3 and sub[3]:
            self.resume_token = str(sub[3])
        ok = await self._call("mining.authorize", [cfg.username, cfg.password])
        if not ok:
            raise sp.StratumError(sp.ERR_UNAUTHORIZED, "authorize rejected")
        self._established = True
        self._established_at = time.monotonic()
        self.connected.set()
        log.info(
            "subscribed: extranonce1=%s en2_size=%d",
            self.extranonce1.hex(), self.extranonce2_size,
        )
        await self._read_loop()

    # -- rpc ---------------------------------------------------------------

    def _alloc_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    async def _send(self, msg: sp.Message) -> None:
        if self._writer is None:
            raise ConnectionError("not connected")
        line = sp.encode_line(msg)
        d = faults.hit("stratum.client.send", self._fault_tag,
                       faults.SEND_ASYNC)
        if d is not None:
            if d.delay:
                await asyncio.sleep(d.delay)
            if d.drop:
                return  # the request vanishes; the caller's timeout decides
            if d.truncate >= 0:
                # partial write then a dead socket: the mid-submit drop
                # scenario — the session loop must reconnect cleanly
                self._writer.write(line[:d.truncate])
                self._writer.close()
                raise ConnectionError("injected short write")
        self._writer.write(line)
        await self._writer.drain()

    async def _call(self, method: str, params: list, msg_id: int | None = None):
        msg_id = msg_id if msg_id is not None else (
            1 if method == "mining.subscribe"
            else 2 if method == "mining.authorize"
            else self._alloc_id()
        )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        try:
            await self._send(sp.Message(id=msg_id, method=method, params=params))
            # the read loop may not be running yet during the handshake: poll
            # the socket inline until our response arrives
            if not self.connected.is_set():
                while not fut.done():
                    line = await asyncio.wait_for(
                        self._reader.readline(), self.config.response_timeout
                    )
                    if not line:
                        raise ConnectionError("closed during handshake")
                    self._dispatch(sp.decode_line(line))
            return await asyncio.wait_for(fut, self.config.response_timeout)
        finally:
            self._pending.pop(msg_id, None)

    async def _read_loop(self) -> None:
        assert self._reader is not None
        while True:
            d = faults.hit("stratum.client.read", self._fault_tag,
                           faults.POINT)
            if d is not None and d.delay:
                await asyncio.sleep(d.delay)
            line = await self._reader.readline()
            if not line:
                raise ConnectionError("connection closed by pool")
            if line.strip():
                try:
                    self._dispatch(sp.decode_line(line))
                except (ValueError, KeyError) as e:
                    log.warning("bad message from pool: %s", e)

    def _dispatch(self, msg: sp.Message) -> None:
        if msg.is_response:
            fut = self._pending.pop(msg.id, None) if msg.id is not None else None
            if fut is not None and not fut.done():
                if msg.error:
                    fut.set_exception(sp.StratumError(*(
                        list(msg.error) + [None, None, None]
                    )[:3]))
                else:
                    fut.set_result(msg.result)
            return
        # notifications
        if msg.method == "mining.notify":
            self._on_notify(msg.params)
        elif msg.method == "mining.set_difficulty":
            if isinstance(msg.params, list) and msg.params:
                self.difficulty = float(msg.params[0])
                if self.on_difficulty:
                    self.on_difficulty(self.difficulty)
                log.info("difficulty -> %g", self.difficulty)
        elif msg.method == "mining.set_resume_token":
            if isinstance(msg.params, list) and msg.params:
                # refreshed after every vardiff retarget so a handoff
                # always recovers the difficulty in force at disconnect
                self.resume_token = str(msg.params[0])
        elif msg.method == "mining.set_extranonce":
            if isinstance(msg.params, list) and len(msg.params) >= 2:
                self.extranonce1 = bytes.fromhex(msg.params[0])
                self.extranonce2_size = int(msg.params[1])
        elif msg.method == "client.reconnect":
            log.info("pool requested reconnect")
            self._reconnect_requested = True
            if self._writer is not None:
                self._writer.close()
        else:
            log.debug("ignoring notification %s", msg.method)

    def _on_notify(self, params) -> None:
        try:
            job = sp.job_from_notify(
                params,
                extranonce1=self.extranonce1,
                extranonce2_size=self.extranonce2_size,
                share_difficulty=self.difficulty,
                algorithm=self.config.algorithm,
            )
        except ValueError as e:
            log.warning("bad mining.notify: %s", e)
            return
        self.current_job = job
        if self.on_job:
            self.on_job(job)

    # -- submission ---------------------------------------------------------

    async def submit(self, share: Share) -> SubmitResult:
        """Submit a share and await the pool verdict."""
        self.stats["shares_submitted"] += 1
        t0 = time.monotonic()
        verdict_arrived = True
        try:
            result = await self._call(
                "mining.submit", sp.submit_params(self.config.username, share)
            )
            latency = time.monotonic() - t0
            accepted = bool(result)
            err = None
        except sp.StratumError as e:
            latency = time.monotonic() - t0
            accepted = False
            err = e.as_triple()
        except (asyncio.TimeoutError, ConnectionError) as e:
            # pool went silent or the session dropped mid-submit: report a
            # rejected share instead of crashing the caller's submit loop
            # (external task cancellation propagates as CancelledError;
            # internal closure surfaces as ConnectionError via the future)
            latency = time.monotonic() - t0
            accepted = False
            verdict_arrived = False
            err = [sp.ERR_OTHER, f"no pool response: {type(e).__name__}", None]
        if accepted:
            self.stats["shares_accepted"] += 1
            self.stats["last_accept_latency"] = latency
        else:
            self.stats["shares_rejected"] += 1
        if verdict_arrived:
            # timeouts/drops would record the CLIENT's timeout value, not
            # pool latency — keep them out of the distribution
            self.latency_sum += latency
            self.latency_count += 1
            for le in self.latency_buckets:
                if latency <= le:
                    self.latency_buckets[le] += 1
        return SubmitResult(accepted=accepted, error=err, latency=latency)
