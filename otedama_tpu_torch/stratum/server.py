"""Asyncio stratum V1 pool server (counterpart of
``otedama_tpu/stratum/server.py``, copied whole).

The lease fields for the sharded front-end and fleet hosts
(``worker_index``/``worker_bits``, ``host_index``/``host_bits``), the
region prefix ``extranonce1_prefix`` and the cross-region
``duplicate_checker`` are carried as in the reference and stay inert
until the slices that set them (ROADMAP A13, A14) land. ``AcceptedShare``
is what the pool ledger (``pool/manager.py``) books.

Reference parity: internal/stratum/unified_stratum.go:517-913 — accept loop
(:598), per-client handler (:616-670), subscribe/authorize/submit handlers
(:690-791), job broadcast (:869-886), per-client vardiff (:950-1003).

Redesigned where the reference is weak:
- extranonce1 is a per-session unique counter (the reference derives it from
  the Unix second, :1009 — every client connecting in the same second would
  collide and search identical nonce spaces);
- ``validateShare`` actually validates (the reference checks only job
  existence/age, :888-913): duplicate window, ntime sanity, exact header
  reconstruction, sha256d, 256-bit target compare, block detection;
- accepted shares flow to an async ``on_share`` hook (pool backend /
  persistence) instead of vanishing.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import struct
import time
from typing import Awaitable, Callable

from otedama_tpu_torch.engine import jobs as jobmod
from otedama_tpu_torch.engine.types import Job, ShareOutcome
from otedama_tpu_torch.engine.vardiff import VardiffConfig, VardiffManager
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.stratum import protocol as sp
from otedama_tpu_torch.stratum import resume as session_resume
from otedama_tpu_torch.utils import faults
from otedama_tpu_torch.utils.histogram import LatencyHistogram
from otedama_tpu_torch.utils.pow_host import (
    SLOW_HOST_ALGOS,
    pow_digest,
    validation_executor,
)

log = logging.getLogger("otedama.stratum.server")


def lease_slice_params(prefix: int | None, worker_index: int,
                       worker_bits: int, host_index: int = 0,
                       host_bits: int = 0) -> tuple[int, int]:
    """Validate the ``[region byte | host_index (host_bits) |
    worker_index (worker_bits) | counter]`` slice parameters and return
    ``(counter_bits, slice_base)``. ONE function defines the
    partitioned lease space for BOTH stratum wires — V1 extranonce1
    (`_alloc_extranonce1`) and V2 channel ids (`stratum/v2.py
    _alloc_channel`) — so the slice math can never drift between them.

    The host field (stratum/fleet.py) sits ABOVE the worker field:
    acceptor hosts of one fleet partition the space exactly like
    workers partition one host's, so cross-host leases stay disjoint
    by construction. ``host_bits = 0`` is the pre-fleet layout —
    existing leases and resume tokens decode identically."""
    if prefix is not None and not (0 <= prefix <= 0xFF):
        raise ValueError(f"region prefix {prefix} is not a byte")
    space_bits = 24 if prefix is not None else 32
    counter_bits = space_bits - host_bits - worker_bits
    if counter_bits < 8:
        raise ValueError(
            f"host_bits {host_bits} + worker_bits {worker_bits} leave "
            f"{counter_bits} counter bits in the {space_bits}-bit lease "
            "space (need >= 8)"
        )
    if not (0 <= host_index < (1 << host_bits)):
        # covers host_bits == 0 too: a nonzero host index with no host
        # field would silently shift out of the lease space
        raise ValueError(
            f"host_index {host_index} does not fit host_bits {host_bits}"
        )
    if worker_bits and not (0 <= worker_index < (1 << worker_bits)):
        raise ValueError(
            f"worker_index {worker_index} does not fit "
            f"worker_bits {worker_bits}"
        )
    return counter_bits, (
        (host_index << (worker_bits + counter_bits))
        | (worker_index << counter_bits)
    )


def compose_lease(prefix: int | None, lease: int) -> int:
    """The full 32-bit lease value: region byte (when sliced) over the
    24-bit [worker|counter] lease, or the bare 32-bit lease. Its
    4-byte big-endian encoding IS the V1 extranonce1 / the V2
    extranonce_prefix suffix."""
    return ((prefix << 24) | lease) if prefix is not None else lease


@dataclasses.dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 3333
    extranonce2_size: int = 4
    initial_difficulty: float = 1.0
    job_max_age: float = 300.0           # submits against older jobs are stale
    ntime_slack: int = 600               # seconds of ntime roll allowed
    max_clients: int = 10000
    vardiff: VardiffConfig = dataclasses.field(default_factory=VardiffConfig)
    # optional custom extranonce1 allocator (session_id -> bytes); the proxy
    # uses this to nest downstream sessions inside an upstream allocation
    extranonce1_factory: Callable[[int], bytes] | None = None
    # -- multi-region replication (pool/regions.py) --------------------------
    # region prefix byte partitioning the extranonce1 space: front-ends
    # with distinct prefixes can NEVER lease overlapping nonce spaces
    # (the bare counter below would collide across processes and
    # silently merge distinct miners' search spaces). None = single
    # front-end legacy allocation.
    extranonce1_prefix: int | None = None
    # -- sharded front-end (stratum/shard.py) --------------------------------
    # worker slice of the lease space, composed UNDER the region prefix:
    # [region byte | worker_index (worker_bits) | counter]. N acceptor
    # workers of one front-end partition the counter space exactly like
    # regions partition the prefix space — a collision across workers
    # would merge distinct miners' search spaces. worker_bits = 0 means
    # unsharded (the whole counter space belongs to this process).
    worker_index: int = 0
    worker_bits: int = 0
    # -- fleet front-end (stratum/fleet.py) ----------------------------------
    # host slice composed ABOVE the worker slice: [region byte |
    # host_index (host_bits) | worker_index (worker_bits) | counter].
    # Acceptor hosts of one fleet partition the lease space exactly
    # like workers partition one host's. host_bits = 0 = single host
    # (the pre-fleet layout, bit-identical leases).
    host_index: int = 0
    host_bits: int = 0
    region_id: int = 0                   # stamped into issued resume tokens
    # deployment-wide HMAC secret for signed session resume tokens
    # (stratum/resume.py); "" disables issuing AND honouring them
    session_secret: str = ""
    resume_token_ttl: float = 3600.0
    # chain-backed cross-region duplicate detection: fn(header80) -> bool
    # (True = this submission was already committed by SOME region). The
    # per-session ``seen`` window is process-local; without this a share
    # replayed to a second region is accepted twice.
    duplicate_checker: Callable[[bytes], bool] | None = None
    # per-IP DDoS protection (reference: internal/security/ddos_protection.go).
    # Tunable like vardiff: operators behind NAT-heavy farms raise the
    # per-IP caps here instead of patching the guard after construction.
    ddos_enabled: bool = True
    ddos: "DDoSConfig | None" = None     # None = DDoSConfig() defaults
    max_line_bytes: int = 16 * 1024      # one JSON-RPC line cap
    # write-path backpressure: replies are written without awaiting the
    # transport per message; a drain is awaited only once the session's
    # write buffer passes ``drain_high_water`` (coalescing flushes so a
    # slow reader costs ITS handler a wait, not a syscall-per-reply
    # everywhere), and a session whose buffer exceeds
    # ``max_write_backlog`` is cut outright — a stalled miner must not
    # grow process memory with queued notifies
    drain_high_water: int = 64 * 1024
    max_write_backlog: int = 1 << 20


@dataclasses.dataclass
class AcceptedShare:
    """What the pool backend receives for every accepted share."""

    session_id: int
    worker_user: str
    job_id: str
    difficulty: float        # difficulty credited (session difficulty at job time)
    actual_difficulty: float # difficulty the digest actually achieved
    digest: bytes
    header: bytes            # the 80-byte header the share hashed
    extranonce2: bytes       # as submitted by the miner
    ntime: int
    nonce_word: int
    is_block: bool
    submitted_at: float
    # the job's algorithm and chain height, carried so downstream batch
    # consumers (device re-validation, the region replicator) never
    # re-derive them — and so a sha256d share's ``digest`` can serve as
    # its submission id without a second host hash of the same header
    algorithm: str = "sha256d"
    block_number: int = 0
    # the session's extranonce1 lease: with coinb1/coinb2 + extranonce2
    # it lets the work-source tier rebuild the EXACT coinbase bytes this
    # share hashed — what an AuxPoW proof must carry (otedama_tpu/work)
    extranonce1: bytes = b""


ShareHook = Callable[[AcceptedShare], Awaitable[None]]
BlockHook = Callable[[bytes, Job, AcceptedShare], Awaitable[None]]


async def drain_if_backed_up(writer: asyncio.StreamWriter,
                             high_water: int) -> None:
    """Coalesced drain: await the transport only past the high-water
    mark, so a per-reply drain (a scheduling point per message, and a
    stall whenever one peer's TCP window closes) becomes a rare flush
    on the connections that actually back up. Shared by the V1 and V2
    servers — ONE statement of the write-backpressure policy."""
    if writer.is_closing():
        return
    transport = writer.transport
    if (transport is not None
            and transport.get_write_buffer_size() > high_water):
        await writer.drain()


@dataclasses.dataclass
class _JobCache:
    """Per-job constants the submit/broadcast hot paths would otherwise
    re-derive per share / per session: the decoded network target and
    the encoded ``mining.notify`` line (the broadcast fans the SAME
    bytes to every session; per-session JSON encoding at four-digit
    connection counts was measurable serialization on the event loop)."""

    network_target: int
    notify_line: bytes        # as broadcast by set_job (its clean flag)
    notify_clean_line: bytes  # clean=True variant for fresh subscribers


@dataclasses.dataclass
class Session:
    id: int
    peer: str
    extranonce1: bytes
    extranonce2_size: int
    writer: asyncio.StreamWriter
    subscribed: bool = False
    authorized: bool = False
    worker_user: str = ""
    difficulty: float = 1.0
    prev_difficulty: float | None = None
    # share targets derived from the difficulties above, cached so the
    # submit path never recomputes ``difficulty_to_target`` per share;
    # ``_send_difficulty`` is the single invalidation point
    target: int = dataclasses.field(
        default_factory=lambda: tgt.difficulty_to_target(1.0)
    )
    prev_target: int | None = None
    connected_at: float = dataclasses.field(default_factory=time.time)
    shares_valid: int = 0
    shares_invalid: int = 0
    seen: set[tuple[str, bytes, int, int]] = dataclasses.field(default_factory=set)
    # job_id -> ShareAssembler: per-(job, extranonce1) header precompute
    # (midstate over the coinbase prefix); pruned with the job set
    assemblers: dict[str, jobmod.ShareAssembler] = dataclasses.field(
        default_factory=dict
    )
    # precomputed faults.hit tag: the disabled-path contract is one load
    # plus a None check, not a str() per read/write (client parity)
    fault_tag: str = ""

    def __post_init__(self):
        self.fault_tag = str(self.id)

    @property
    def vardiff_key(self) -> str:
        return f"{self.id}"


class StratumServer:
    """One listening pool endpoint."""

    def __init__(
        self,
        config: ServerConfig | None = None,
        on_share: ShareHook | None = None,
        on_block: BlockHook | None = None,
    ):
        self.config = config or ServerConfig()
        self.on_share = on_share
        self.on_block = on_block
        self.vardiff = VardiffManager(
            self.config.vardiff, self.config.initial_difficulty
        )
        self.sessions: dict[int, Session] = {}
        self.jobs: dict[str, Job] = {}
        self.job_cache: dict[str, _JobCache] = {}
        self.current_job: Job | None = None
        # share-accept latency: submit-received -> verdict-written (the
        # pool-side half of the reference's <50 ms target; the client
        # exports the wire-inclusive half)
        self.latency = LatencyHistogram()
        self.stats = {
            "connections_total": 0,
            "shares_total": 0,
            "shares_valid": 0,
            "shares_invalid": 0,
            "blocks_found": 0,
            "share_hook_failures": 0,
            "hook_rejects": 0,
            "backlog_disconnects": 0,
            "resumes_accepted": 0,
            "resumes_rejected": 0,
            "extranonce_collisions": 0,
        }
        self._server: asyncio.AbstractServer | None = None
        self._next_session = 1
        self._next_extranonce1 = 1
        # region-prefixed lease counter: seeded randomly on first use
        # (per boot) so a restart does not re-lease nonce spaces still
        # alive in sibling-held resume tokens
        self._region_counter: int | None = None
        self._token_refresh: asyncio.Task | None = None
        from otedama_tpu_torch.security.ddos import DDoSProtection

        self.ddos: DDoSProtection | None = (
            DDoSProtection(self.config.ddos) if self.config.ddos_enabled else None
        )

    # -- lifecycle ----------------------------------------------------------

    async def start(self, sock=None) -> None:
        """``sock``: an optional pre-made listening socket. The sharded
        front-end (stratum/shard.py) binds its workers' sockets itself —
        SO_REUSEPORT siblings on one port, or one inherited fd — and the
        server must serve exactly that socket, not open its own."""
        if sock is not None:
            self._server = await asyncio.start_server(
                self._handle_client, sock=sock
            )
        else:
            self._server = await asyncio.start_server(
                self._handle_client, self.config.host, self.config.port
            )
        addr = self._server.sockets[0].getsockname()
        self.config = dataclasses.replace(self.config, port=addr[1])
        if self.config.session_secret:
            self._token_refresh = asyncio.create_task(
                self._token_refresh_loop())
        log.info("stratum server listening on %s:%d", addr[0], addr[1])

    async def stop(self) -> None:
        if self._token_refresh is not None:
            self._token_refresh.cancel()
            try:
                await self._token_refresh
            except (asyncio.CancelledError, Exception):
                pass
            self._token_refresh = None
        if self._server is not None:
            self._server.close()
        # the sessions close before the wait: since Python 3.12.1
        # ``wait_closed`` waits for every connection the server accepted,
        # so waiting first would hang for as long as a miner stays on
        for s in list(self.sessions.values()):
            s.writer.close()
        self.sessions.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _token_refresh_loop(self) -> None:
        """Re-issue every subscribed session's resume token well inside
        its ttl: vardiff retargets are the other refresh point, but a
        miner that tuned early and then mined STABLY for longer than
        ``resume_token_ttl`` would otherwise hold an expired token and
        lose its state in exactly the long-lived-session handoff the
        tokens exist for."""
        interval = max(1.0, self.config.resume_token_ttl / 4)
        while True:
            await asyncio.sleep(interval)
            for s in list(self.sessions.values()):
                if s.subscribed:
                    self._send_notification(
                        s, "mining.set_resume_token",
                        [self._issue_resume_token(s, s.difficulty)],
                    )

    @property
    def port(self) -> int:
        return self.config.port

    # -- jobs ---------------------------------------------------------------

    def set_job(self, job: Job, clean: bool = True) -> None:
        """Register a job and broadcast it to all subscribed sessions.

        The notify line is encoded ONCE and the same bytes fan out to
        every session (per-session ``sp.encode_line`` of an identical
        payload was pure event-loop serialization at scale); the decoded
        network target is cached alongside for the submit path."""
        self.jobs[job.job_id] = job
        line = sp.encode_line(sp.Message(
            method="mining.notify", params=sp.notify_params(job, clean)
        ))
        clean_line = line if clean else sp.encode_line(sp.Message(
            method="mining.notify", params=sp.notify_params(job, True)
        ))
        self.job_cache[job.job_id] = _JobCache(
            network_target=tgt.bits_to_target(job.nbits),
            notify_line=line,
            notify_clean_line=clean_line,
        )
        self.current_job = job
        self._expire_jobs()
        for s in self.sessions.values():
            if s.subscribed:
                self._write_line(s, line)
        log.info("job %s broadcast to %d sessions", job.job_id, len(self.sessions))

    def _expire_jobs(self) -> None:
        cutoff = time.time() - 2 * self.config.job_max_age
        evicted = [
            j for j, job in self.jobs.items() if job.received_at < cutoff
        ]
        for jid in evicted:
            del self.jobs[jid]
            self.job_cache.pop(jid, None)
        if evicted:
            # per-session state keyed by job id follows the job set out:
            # ``seen`` (duplicate window) previously grew without bound
            # over a long-lived session, and the assembler cache would
            # pin dead jobs' midstates
            # safe to iterate: per-session caches are mutated on the
            # event loop only (_prepare/_judge) — the slow-algo executor
            # computes pure digests and never touches session state
            live = self.jobs
            for s in self.sessions.values():
                if s.seen:
                    s.seen.difference_update(
                        [k for k in s.seen if k[0] not in live]
                    )
                for jid in [j for j in s.assemblers if j not in live]:
                    del s.assemblers[jid]

    # -- connection handling ------------------------------------------------

    def _alloc_extranonce1(self, session_id: int) -> bytes:
        if self.config.extranonce1_factory is not None:
            return self.config.extranonce1_factory(session_id)
        prefix = self.config.extranonce1_prefix
        wbits = self.config.worker_bits
        hbits = self.config.host_bits
        if prefix is None and wbits == 0 and hbits == 0:
            # single front-end, single process: the legacy bare counter
            v = self._next_extranonce1
            self._next_extranonce1 += 1
            return struct.pack(">I", v & 0xFFFFFFFF)
        # partitioned lease: [region prefix byte?][worker slice][counter].
        # The region byte keeps FRONT-ENDS disjoint (pool/regions.py);
        # the worker slice keeps one front-end's N acceptor WORKERS
        # disjoint (stratum/shard.py). The counter starts at a RANDOM
        # point per boot: a restarted process would otherwise restart at
        # 1 while pre-restart leases live on inside resume tokens
        # (ttl-bounded) held by miners handed off to siblings/survivors,
        # re-creating exactly the overlap the partitioning prevents. A
        # collision with a LIVE local lease (a resumed pre-restart
        # session) is skipped, counted, and logged — the collision
        # assertion fires only when the scan cannot find a free lease at
        # all (the space is saturated, or another allocator is flooding
        # OUR partition: two processes misconfigured with one slice).
        counter_bits, slice_base = lease_slice_params(
            prefix, self.config.worker_index, wbits,
            self.config.host_index, hbits)
        if self._region_counter is None:
            import secrets

            self._region_counter = secrets.randbits(counter_bits)
        live = {s.extranonce1 for s in self.sessions.values()}
        for _ in range(4096):
            v = self._region_counter
            self._region_counter = (v + 1) % (1 << counter_bits)
            en1 = compose_lease(prefix, slice_base | v).to_bytes(4, "big")
            if en1 not in live:
                return en1
            self.stats["extranonce_collisions"] += 1
            log.warning(
                "extranonce1 %s already leased (resumed pre-restart "
                "session?); skipping", en1.hex())
        raise AssertionError(
            f"no free extranonce1 lease in slice (prefix={prefix} "
            f"host={self.config.host_index}/{hbits} bits "
            f"worker={self.config.worker_index}/{wbits} bits): the space "
            "is saturated or the slice is not exclusively ours"
        )

    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if len(self.sessions) >= self.config.max_clients:
            writer.close()
            return
        peer = writer.get_extra_info("peername")
        ip = peer[0] if peer else "?"
        if self.ddos is not None and not self.ddos.allow_connect(ip):
            log.warning("ddos guard refused connect from %s", ip)
            writer.close()
            return
        session_id = self._next_session
        self._next_session += 1
        try:
            extranonce1 = self._alloc_extranonce1(session_id)
        except Exception as e:
            # e.g. a proxy whose upstream allocation has no session space
            # left — refuse this client, keep serving the others
            log.warning("refusing client %s: %s", peer, e)
            if self.ddos is not None:
                self.ddos.release(ip)
            writer.close()
            return
        session = Session(
            id=session_id,
            peer=f"{peer[0]}:{peer[1]}" if peer else "?",
            extranonce1=extranonce1,
            extranonce2_size=self.config.extranonce2_size,
            writer=writer,
        )
        self.sessions[session.id] = session
        self.stats["connections_total"] += 1
        log.info("client %d connected from %s", session.id, session.peer)
        try:
            while True:
                d = faults.hit("stratum.server.read", session.fault_tag,
                                faults.POINT)
                if d is not None and d.delay:
                    await asyncio.sleep(d.delay)
                try:
                    line = await reader.readuntil(b"\n")
                except asyncio.LimitOverrunError:
                    # oversized line: a 64 MB "json" must not buffer — cut
                    # the connection and strike the IP
                    log.warning("client %d line overrun", session.id)
                    if self.ddos is not None:
                        self.ddos.strike(ip, "overrun")
                    break
                except asyncio.IncompleteReadError as e:
                    if e.partial:
                        line = e.partial
                    else:
                        break
                if not line:
                    break
                if len(line) > self.config.max_line_bytes:
                    # the line cap holds with or without the ddos layer
                    if self.ddos is not None:
                        self.ddos.strike(ip, "oversized-line")
                    log.warning("client %d oversized line dropped", session.id)
                    break
                if self.ddos is not None and not self.ddos.track_bytes(ip, len(line)):
                    log.warning("client %d cut: bandwidth budget", session.id)
                    break
                if not line.strip():
                    continue
                try:
                    msg = sp.decode_line(line)
                except ValueError:
                    log.warning("client %d sent invalid JSON", session.id)
                    if self.ddos is not None and self.ddos.strike(ip, "bad-json"):
                        log.warning("client %d banned: junk flood", session.id)
                        break
                    continue
                await self._handle_message(session, msg)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self.sessions.pop(session.id, None)
            self.vardiff.forget(session.vardiff_key)
            if self.ddos is not None:
                self.ddos.release(ip)
            writer.close()
            log.info("client %d disconnected", session.id)

    # -- message handling ---------------------------------------------------

    async def _handle_message(self, session: Session, msg: sp.Message) -> None:
        method = msg.method or ""
        if method == "mining.submit":
            # share-accept latency SLO: submit-received -> verdict-written.
            # _on_submit observes t0 at each verdict-write site, so block
            # hooks / vardiff traffic AFTER the verdict stay out of the
            # distribution (they delay the NEXT share, which the next
            # measurement then shows)
            t0 = time.monotonic()
            try:
                await self._on_submit(session, msg, t0)
            except sp.StratumError as e:
                await self._reply_error(session, msg.id, e)
                self.latency.observe(time.monotonic() - t0)
            return
        try:
            if method == "mining.subscribe":
                await self._on_subscribe(session, msg)
            elif method == "mining.authorize":
                await self._on_authorize(session, msg)
            elif method == "mining.get_transactions":
                await self._reply(session, msg.id, [])
            elif method == "mining.extranonce.subscribe":
                await self._reply(session, msg.id, True)
            elif method == "mining.ping":
                await self._reply(session, msg.id, "pong")
            else:
                await self._reply_error(
                    session, msg.id, sp.StratumError(sp.ERR_OTHER, f"unknown method {method!r}")
                )
        except sp.StratumError as e:
            await self._reply_error(session, msg.id, e)

    def _write_line(self, session: Session, line: bytes) -> None:
        """Every byte to a miner passes one seam (fault point
        stratum.server.write): drop swallows the line, truncate writes a
        partial line and cuts the socket — the miner-side read loop must
        survive both."""
        d = faults.hit("stratum.server.write", session.fault_tag,
                       faults.SEND_SYNC)
        if d is not None:
            if d.drop:
                return
            if d.truncate >= 0:
                session.writer.write(line[:d.truncate])
                session.writer.close()
                return
        session.writer.write(line)
        transport = session.writer.transport
        if (transport is not None
                and transport.get_write_buffer_size()
                > self.config.max_write_backlog):
            # a peer that stopped reading must not buffer unbounded job
            # broadcasts in process memory: abort (close would keep the
            # backlog resident until "sent"), read loop reaps the session
            self.stats["backlog_disconnects"] += 1
            log.warning(
                "client %d cut: write backlog %d over cap",
                session.id, transport.get_write_buffer_size(),
            )
            transport.abort()

    async def _maybe_drain(self, session: Session) -> None:
        await drain_if_backed_up(session.writer, self.config.drain_high_water)

    async def _reply(self, session: Session, msg_id, result) -> None:
        self._write_line(session, sp.encode_line(sp.Message(id=msg_id, result=result)))
        await self._maybe_drain(session)

    async def _reply_error(self, session: Session, msg_id, err: sp.StratumError) -> None:
        self._write_line(
            session,
            sp.encode_line(sp.Message(id=msg_id, result=None, error=err.as_triple())),
        )
        await self._maybe_drain(session)

    def _send_notification(self, session: Session, method: str, params: list) -> None:
        self._write_line(session, sp.encode_line(sp.Message(method=method, params=params)))

    def _issue_resume_token(self, session: Session, difficulty: float) -> str:
        return session_resume.issue_token(
            self.config.session_secret, self.config.region_id,
            session.extranonce1, difficulty,
        )

    def _difficulty_lines(self, session: Session, difficulty: float) -> bytes:
        """Retarget the session and return the wire bytes announcing it
        (set_difficulty, plus the refreshed resume token — the token
        must always describe the CURRENT session state: a handoff after
        a vardiff retarget must recover the tuned difficulty, not the
        one in force at subscribe time). Returned instead of written so
        callers can coalesce the announcement with adjacent messages
        into ONE transport write — a send syscall per message is the
        dominant per-connection cost at five-digit connection counts."""
        session.prev_difficulty = session.difficulty
        session.prev_target = session.target
        session.difficulty = difficulty
        session.target = tgt.difficulty_to_target(difficulty)
        lines = sp.encode_line(sp.Message(
            method="mining.set_difficulty", params=[difficulty]))
        if self.config.session_secret and session.subscribed:
            lines += sp.encode_line(sp.Message(
                method="mining.set_resume_token",
                params=[self._issue_resume_token(session, difficulty)]))
        return lines

    def _send_difficulty(self, session: Session, difficulty: float) -> None:
        self._write_line(session, self._difficulty_lines(session, difficulty))

    async def _try_resume(self, session: Session, token: str) -> float | None:
        """Validate a presented resume token (any region's). Returns the
        recovered difficulty after adopting the token's extranonce1, or
        None — every defect degrades to a fresh session, never a dead
        one (the miner is mid-reconnect; an error would strand it)."""
        state = None
        try:
            d = faults.hit("region.handoff", session.fault_tag, faults.POINT)
            if d is not None and d.delay:
                # a slow verifier delays only THIS miner's subscribe
                await asyncio.sleep(d.delay)
            state = session_resume.verify_token(
                self.config.session_secret, token,
                ttl=self.config.resume_token_ttl,
            )
        except faults.FaultInjectedError:
            state = None
        if state is not None and any(
            s.extranonce1 == state.extranonce1
            for s in self.sessions.values() if s is not session
        ):
            # the leased nonce space is live HERE (replayed token, or the
            # "dead" session still draining) — refuse the alias
            state = None
        if state is None:
            self.stats["resumes_rejected"] += 1
            log.info("client %d resume token rejected; fresh session",
                     session.id)
            return None
        session.extranonce1 = state.extranonce1
        # seed vardiff with the recovered difficulty, or its fresh
        # window (created at initial_difficulty) would snap the miner
        # back on the very first retarget
        self.vardiff.seed(session.vardiff_key, state.difficulty)
        self.stats["resumes_accepted"] += 1
        log.info("client %d resumed session issued by region %d (en1=%s)",
                 session.id, state.region_id, state.extranonce1.hex())
        return state.difficulty

    async def _on_subscribe(self, session: Session, msg: sp.Message) -> None:
        params = msg.params or []
        difficulty = self.config.initial_difficulty
        # param 2 is classic stratum's "previous session id" slot: when
        # session resume is configured it carries the signed token any
        # region of the deployment can verify (stratum/resume.py)
        token = str(params[1]) if len(params) > 1 and params[1] else ""
        if token and self.config.session_secret:
            recovered = await self._try_resume(session, token)
            if recovered is not None:
                difficulty = recovered
        session.subscribed = True
        result = [
            [
                ["mining.set_difficulty", str(session.id)],
                ["mining.notify", str(session.id)],
            ],
            session.extranonce1.hex(),
            session.extranonce2_size,
        ]
        if self.config.session_secret:
            # 4th element: the resume token (clients reading only the
            # canonical 3 ignore it)
            result.append(self._issue_resume_token(session, difficulty))
        # ONE wire flush for the whole subscribe dance: the reply,
        # set_difficulty (+ resume token), and the current job's cached
        # clean notify bytes were four separate transport writes — four
        # send syscalls per connecting miner, which made the connect
        # ramp's syscall bill the dominant cost of a five-digit fleet
        lines = sp.encode_line(sp.Message(id=msg.id, result=result))
        lines += self._difficulty_lines(session, difficulty)
        session.prev_difficulty = None
        session.prev_target = None
        if self.current_job is not None:
            # the cached clean=True notify bytes — same line every fresh
            # subscriber gets (job_cache is written by set_job, so a
            # current_job always has an entry)
            cache = self.job_cache.get(self.current_job.job_id)
            if cache is not None:
                lines += cache.notify_clean_line
            else:
                lines += sp.encode_line(sp.Message(
                    method="mining.notify",
                    params=sp.notify_params(self.current_job, True)))
        self._write_line(session, lines)
        await self._maybe_drain(session)

    async def _on_authorize(self, session: Session, msg: sp.Message) -> None:
        from otedama_tpu_torch.security import validation as val

        params = msg.params or []
        if not params:
            raise sp.StratumError(sp.ERR_OTHER, "missing worker name")
        try:
            session.worker_user = val.validate_worker_name(str(params[0]))
        except val.ValidationError as e:
            raise sp.StratumError(sp.ERR_UNAUTHORIZED, str(e)) from None
        session.authorized = True
        await self._reply(session, msg.id, True)
        log.info("client %d authorized as %s", session.id, session.worker_user)

    # -- share validation (the real thing) ----------------------------------

    async def _on_submit(self, session: Session, msg: sp.Message,
                         t0: float | None = None) -> None:
        if t0 is None:
            t0 = time.monotonic()
        if not session.authorized:
            raise sp.StratumError(sp.ERR_UNAUTHORIZED, "not authorized")
        sub = sp.ShareSubmission.from_params(msg.params or [])
        self.stats["shares_total"] += 1
        reject, job, header = self._prepare(session, sub)
        if reject is not None:
            outcome, accepted = reject, None
        else:
            if job.algorithm in SLOW_HOST_ALGOS:
                # scrypt/x11/ethash host digests are real CPU work (the
                # first ethash share of an epoch builds a whole cache):
                # off the event loop, or one share stalls every connected
                # miner. Only the PURE digest goes to the thread — all
                # session-state mutation stays on the loop, so the
                # executor never races set_job's cache pruning. On a
                # DEDICATED pool: the default executor carries engine
                # backend dispatches, and blocked validations there
                # would starve mining.
                digest = await asyncio.get_running_loop().run_in_executor(
                    validation_executor(), pow_digest, header,
                    job.algorithm, job.block_number,
                )
            else:
                digest = pow_digest(header, job.algorithm,
                                    block_number=job.block_number)
            outcome, accepted = self._judge(session, sub, job, header, digest)
        if outcome in (ShareOutcome.ACCEPTED, ShareOutcome.BLOCK_FOUND):
            # persist BEFORE the accept verdict: every accept a miner ever
            # sees must be durable exactly once, so a failing share hook
            # (db fault) turns into a reject the miner can see — never an
            # accepted share the books don't have (tests/test_chaos.py)
            if accepted is not None and self.on_share is not None:
                try:
                    await self.on_share(accepted)
                except sp.StratumError as e:
                    # a POLICY reject decided by the ledger owner (e.g.
                    # the shard supervisor or region replicator found a
                    # cross-worker duplicate only the parent's window can
                    # see): delivered to the miner verbatim. The share
                    # stays in ``seen`` — it IS a known submission, and a
                    # resubmit must reject the same way, not re-commit.
                    session.shares_invalid += 1
                    self.stats["shares_invalid"] += 1
                    self.stats["hook_rejects"] += 1
                    await self._reply_error(session, msg.id, e)
                    self.latency.observe(time.monotonic() - t0)
                    return
                except Exception:
                    log.exception("share hook failed; rejecting share")
                    # un-remember the share: it was never credited, so a
                    # resubmit after accounting recovers must be able to
                    # land, not die as a phantom duplicate (fields from
                    # the SAME AcceptedShare _judge keyed on, so the
                    # two sites cannot drift apart)
                    session.seen.discard(
                        (accepted.job_id, accepted.extranonce2,
                         accepted.ntime, accepted.nonce_word))
                    session.shares_invalid += 1
                    self.stats["shares_invalid"] += 1
                    self.stats["share_hook_failures"] += 1
                    await self._reply_error(session, msg.id, sp.StratumError(
                        sp.ERR_OTHER, "share accounting unavailable"))
                    self.latency.observe(time.monotonic() - t0)
                    # a block candidate is still real: chain submission is
                    # independent of share accounting (own retry loop) and
                    # a db hiccup must never cost the block reward
                    if accepted.is_block:
                        self.stats["blocks_found"] += 1
                        if self.on_block is not None and job is not None:
                            try:
                                await self.on_block(
                                    accepted.header, job, accepted)
                            except Exception:
                                log.exception("block hook failed")
                    return
            session.shares_valid += 1
            self.stats["shares_valid"] += 1
            self.vardiff.record_share(session.vardiff_key)
            # accepted-verdict fast path: this exact reply is written
            # once per accepted share — the single hottest line on the
            # server — and its JSON shape is fixed, so skip the
            # Message/json.dumps round trip for the common integer id
            if type(msg.id) is int:
                self._write_line(
                    session,
                    b'{"id":%d,"result":true,"error":null}\n' % msg.id)
                await self._maybe_drain(session)
            else:
                await self._reply(session, msg.id, True)
            self.latency.observe(time.monotonic() - t0)
            if accepted is not None and accepted.is_block:
                self.stats["blocks_found"] += 1
                if self.on_block is not None and job is not None:
                    try:
                        await self.on_block(accepted.header, job, accepted)
                    except Exception:
                        # same guard as the hook-failure branch above:
                        # a failing block hook (newly fallible through
                        # the share bus) must not tear down the block
                        # finder's session — submission has its own
                        # retry loop
                        log.exception("block hook failed")
        else:
            session.shares_invalid += 1
            self.stats["shares_invalid"] += 1
            code = {
                ShareOutcome.REJECTED_STALE: sp.ERR_STALE,
                ShareOutcome.REJECTED_DUPLICATE: sp.ERR_DUPLICATE,
                ShareOutcome.REJECTED_LOW_DIFF: sp.ERR_LOW_DIFF,
                ShareOutcome.REJECTED_BAD_JOB: sp.ERR_STALE,
            }.get(outcome, sp.ERR_OTHER)
            await self._reply_error(
                session, msg.id, sp.StratumError(code, outcome.value)
            )
            self.latency.observe(time.monotonic() - t0)
        new_diff = self.vardiff.maybe_retarget(session.vardiff_key)
        if new_diff is not None and new_diff != session.difficulty:
            self._send_difficulty(session, new_diff)
            await self._maybe_drain(session)

    def _prepare(
        self, session: Session, sub: sp.ShareSubmission
    ) -> tuple[ShareOutcome | None, Job | None, bytes | None]:
        """Structural checks + header assembly (EVENT LOOP ONLY — this
        and _judge are the sole mutators of per-session caches, so the
        slow-algo executor never touches shared state). Returns
        (reject_outcome, None, None) or (None, job, header)."""
        job = self.jobs.get(sub.job_id)
        if job is None:
            return ShareOutcome.REJECTED_BAD_JOB, None, None
        if job.is_expired(self.config.job_max_age):
            return ShareOutcome.REJECTED_STALE, None, None
        if len(sub.extranonce2) != session.extranonce2_size:
            return ShareOutcome.REJECTED_INVALID, None, None
        if abs(sub.ntime - job.ntime) > self.config.ntime_slack:
            return ShareOutcome.REJECTED_INVALID, None, None
        key = (sub.job_id, sub.extranonce2, sub.ntime, sub.nonce_word)
        if key in session.seen:
            return ShareOutcome.REJECTED_DUPLICATE, None, None

        # per-(job, extranonce1) assembler: coinbase-prefix midstate +
        # frozen header fields instead of dataclasses.replace + a full
        # rebuild per submit (bit-identical — tests pin it)
        asm = session.assemblers.get(sub.job_id)
        if asm is None:
            asm = session.assemblers[sub.job_id] = jobmod.ShareAssembler(
                job, session.extranonce1, session.extranonce2_size
            )
        try:
            header = asm.header(sub.extranonce2, sub.ntime, sub.nonce_word)
        except ValueError:
            return ShareOutcome.REJECTED_INVALID, None, None
        # cross-region duplicate window: ``session.seen`` above is
        # process-local, so a share replayed to another front-end needs
        # the chain-backed index (pool/regions.py) to die here too
        checker = self.config.duplicate_checker
        if checker is not None and checker(header):
            return ShareOutcome.REJECTED_DUPLICATE, None, None
        return None, job, header

    def _judge(
        self, session: Session, sub: sp.ShareSubmission, job: Job,
        header: bytes, digest: bytes
    ) -> tuple[ShareOutcome, AcceptedShare | None]:
        """Target comparison + share record (event loop only)."""
        # credit at the difficulty the session was mining at (cached
        # target, invalidated by _send_difficulty); allow the previous
        # difficulty during a retarget window
        credit_diff = session.difficulty
        if not tgt.hash_meets_target(digest, session.target):
            if session.prev_target is not None and tgt.hash_meets_target(
                digest, session.prev_target
            ):
                credit_diff = session.prev_difficulty
            else:
                return ShareOutcome.REJECTED_LOW_DIFF, None
        # remembered only once it VALIDATES (V2 server parity): garbage
        # submissions must cost the submitter a recompute, not this
        # process unbounded dedup memory — and a rejected share must
        # reject the same way twice, not mutate into a "duplicate"
        session.seen.add(
            (sub.job_id, sub.extranonce2, sub.ntime, sub.nonce_word)
        )

        cache = self.job_cache.get(sub.job_id)
        net_target = (cache.network_target if cache is not None
                      else tgt.bits_to_target(job.nbits))
        is_block = tgt.hash_meets_target(digest, net_target)
        accepted = AcceptedShare(
            session_id=session.id,
            worker_user=session.worker_user,
            job_id=sub.job_id,
            difficulty=credit_diff,
            actual_difficulty=tgt.difficulty_of_digest(digest),
            digest=digest,
            header=header,
            extranonce2=sub.extranonce2,
            ntime=sub.ntime,
            nonce_word=sub.nonce_word,
            is_block=is_block,
            submitted_at=time.time(),
            algorithm=job.algorithm,
            block_number=job.block_number,
            extranonce1=session.extranonce1,
        )
        outcome = ShareOutcome.BLOCK_FOUND if is_block else ShareOutcome.ACCEPTED
        return outcome, accepted

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            **self.stats,
            "sessions": len(self.sessions),
            "jobs_cached": len(self.jobs),
            "current_job": self.current_job.job_id if self.current_job else None,
            "accept_latency": self.latency.snapshot(),
        }
