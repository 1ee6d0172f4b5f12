"""P2P node: peer management, flood gossip, discovery, keepalive
(counterpart of ``otedama_tpu/p2p/node.py``).

Reference parity: internal/p2p/optimized_network.go:20-68 (Network with
NodeID, peer map, max peers, handler registry, stats), node.go, handlers.go
:58-447 (per-type handlers, flood propagation with exclude-origin),
discovery via peer-list exchange (the reference's DHT reduces to this in
its tests; loopback multi-node tests are the strategy —
test/integration/p2p_integration_test.go:16-361).

asyncio-native redesign: one reader task per peer, dedup by message_id with
a bounded LRU window, broadcast excludes the origin peer, peer slots capped
with graceful rejects.

Where the port differs from the reference: ``stop()`` closes every
connection the listener accepted — peers and handshakes still in flight
— before it awaits ``Server.wait_closed()``. Since Python 3.12.1 that
wait returns only once every accepted connection is gone, so a
handshake left open there would hold the stop for its 10 s read timeout.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import secrets
import time
from collections import OrderedDict
from typing import Awaitable, Callable

from otedama_tpu_torch.p2p.messages import MessageType, P2PMessage, read_frame
from otedama_tpu_torch.utils import faults

log = logging.getLogger("otedama.p2p")

Handler = Callable[["P2PNode", "Peer", P2PMessage], Awaitable[None]]

# v2: share gossip carries PoW'd headers and sync is locator-based
# (p2p/sharechain.py); the old claimed-difficulty ledger schema is gone
PROTOCOL_VERSION = 2


@dataclasses.dataclass
class NodeConfig:
    host: str = "127.0.0.1"
    port: int = 0                    # 0 = ephemeral
    max_peers: int = 32
    connect_timeout: float = 10.0
    keepalive_seconds: float = 30.0
    peer_timeout: float = 90.0
    dedup_window: int = 4096
    bootstrap: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    # pinned node id (64 hex chars) — deterministic overlays for seeded
    # chaos tests (fault points tag by id prefix); "" = random
    node_id: str = ""


@dataclasses.dataclass
class Peer:
    node_id: str                     # hex
    addr: str
    listen_port: int
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    outbound: bool
    connected_at: float = dataclasses.field(default_factory=time.time)
    last_seen: float = dataclasses.field(default_factory=time.time)
    latency: float = 0.0
    messages_in: int = 0
    messages_out: int = 0

    def send(self, msg: P2PMessage) -> None:
        d = faults.hit("p2p.peer.send", self.node_id[:12],
                       faults.SEND_SYNC)
        if d is not None:
            if d.drop:
                return  # lossy link: gossip must still converge via others
            if d.truncate >= 0:
                # corrupt the stream mid-frame: the remote read loop sees
                # a bad magic / short read and must drop the peer cleanly
                self.writer.write(msg.encode()[:d.truncate])
                self.writer.close()
                raise ConnectionError("injected short write")
        self.writer.write(msg.encode())
        self.messages_out += 1


class P2PNode:
    def __init__(self, config: NodeConfig | None = None):
        self.config = config or NodeConfig()
        self.node_id = self.config.node_id or secrets.token_hex(32)
        self.peers: dict[str, Peer] = {}
        self.handlers: dict[MessageType, Handler] = {}
        self.stats = {
            "messages_received": 0,
            "messages_sent": 0,
            "messages_deduped": 0,
            "peers_connected_total": 0,
        }
        self._seen: OrderedDict[str, None] = OrderedDict()
        self._server: asyncio.AbstractServer | None = None
        self._tasks: list[asyncio.Task] = []
        self._peer_tasks: dict[str, asyncio.Task] = {}
        self._ping_sent: dict[str, float] = {}
        self._dialing: set[tuple[str, int]] = set()
        # writers of inbound connections whose handshake is still running
        self._handshaking: set = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_inbound, self.config.host, self.config.port
        )
        self.config.port = self._server.sockets[0].getsockname()[1]
        self._tasks.append(asyncio.create_task(self._keepalive_loop()))
        log.info(
            "p2p node %s listening on %s:%d",
            self.node_id[:12], self.config.host, self.config.port,
        )
        for host, port in self.config.bootstrap:
            try:
                await self.connect(host, port)
            except OSError as e:
                log.warning("bootstrap %s:%d failed: %s", host, port, e)

    async def stop(self) -> None:
        # snapshot writers FIRST: awaiting the cancelled peer tasks runs
        # their finally-block _drop_peer, which empties self.peers — a
        # later snapshot would await nothing and leak the transports
        writers = [p.writer for p in self.peers.values()]
        # cancel the keepalive loop AND in-flight _connect_quietly dials
        # (discovery appends them to _tasks): a dial completing after stop
        # would register a peer loop nobody will ever reap
        for t in self._tasks + list(self._peer_tasks.values()):
            t.cancel()
        await asyncio.gather(
            *self._tasks, *self._peer_tasks.values(), return_exceptions=True
        )
        self._tasks.clear()
        self._peer_tasks.clear()
        self._dialing.clear()
        writers += list(self._handshaking)
        self._handshaking.clear()
        for w in writers:
            w.close()
        self.peers.clear()
        if self._server is not None:
            self._server.close()
            # every accepted connection is closed above, so the wait ends
            await self._server.wait_closed()
            self._server = None
        # close() only schedules the transport teardown; without awaiting
        # wait_closed() repeated start/stop cycles leak live transports
        await asyncio.gather(
            *(self._await_writer_closed(w) for w in writers),
            return_exceptions=True,
        )

    @staticmethod
    async def _await_writer_closed(writer) -> None:
        wait = getattr(writer, "wait_closed", None)
        if wait is None:
            return  # non-transport writer (in-memory test links)
        try:
            await asyncio.wait_for(wait(), 5.0)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass  # a wedged transport must not hang shutdown

    @property
    def port(self) -> int:
        return self.config.port

    # -- connections --------------------------------------------------------

    async def connect(self, host: str, port: int) -> Peer:
        """Dial a peer and run the handshake."""
        if len(self.peers) >= self.config.max_peers:
            raise ConnectionError("peer slots full")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), self.config.connect_timeout
        )
        try:
            hello = P2PMessage(
                MessageType.HANDSHAKE,
                {
                    "version": PROTOCOL_VERSION,
                    "listen_port": self.config.port,
                },
                sender=self.node_id,
            )
            writer.write(hello.encode())
            await writer.drain()
            ack = P2PMessage.decode_frame(
                await asyncio.wait_for(read_frame(reader), self.config.connect_timeout)
            )
        except BaseException:
            writer.close()
            raise
        if ack.type != MessageType.HANDSHAKE_ACK:
            writer.close()
            raise ConnectionError(f"expected handshake ack, got {ack.type}")
        if ack.sender == self.node_id:
            writer.close()
            raise ConnectionError("connected to self")
        existing = self.peers.get(ack.sender)
        if existing is not None:
            # simultaneous mutual dial: keep the established connection
            writer.close()
            return existing
        peer = self._register_peer(
            ack.sender, reader, writer,
            listen_port=int(ack.payload.get("listen_port", port)),
            outbound=True,
        )
        return peer

    async def _on_inbound(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._handshaking.add(writer)
        try:
            await self._handshake_inbound(reader, writer)
        finally:
            self._handshaking.discard(writer)

    async def _handshake_inbound(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            hello = P2PMessage.decode_frame(
                await asyncio.wait_for(read_frame(reader), 10.0)
            )
        except (ValueError, asyncio.TimeoutError, asyncio.IncompleteReadError):
            writer.close()
            return
        if hello.type != MessageType.HANDSHAKE or not hello.sender:
            writer.close()
            return
        if len(self.peers) >= self.config.max_peers or hello.sender in self.peers:
            writer.close()
            return
        ack = P2PMessage(
            MessageType.HANDSHAKE_ACK,
            {"version": PROTOCOL_VERSION, "listen_port": self.config.port},
            sender=self.node_id,
        )
        writer.write(ack.encode())
        await writer.drain()
        if hello.sender in self.peers:
            # a concurrent handshake for the same node won the race while we
            # awaited the drain — keep the registered connection
            writer.close()
            return
        self._register_peer(
            hello.sender, reader, writer,
            listen_port=int(hello.payload.get("listen_port", 0)),
            outbound=False,
        )

    def _register_peer(
        self,
        node_id: str,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        listen_port: int,
        outbound: bool,
    ) -> Peer:
        addr = writer.get_extra_info("peername")
        peer = Peer(
            node_id=node_id,
            addr=f"{addr[0]}:{addr[1]}" if addr else "?",
            listen_port=listen_port,
            reader=reader,
            writer=writer,
            outbound=outbound,
        )
        self.peers[node_id] = peer
        self.stats["peers_connected_total"] += 1
        self._peer_tasks[node_id] = asyncio.create_task(self._peer_loop(peer))
        log.info("peer %s connected (%s)", node_id[:12], "out" if outbound else "in")
        return peer

    def _drop_peer(self, peer: Peer) -> None:
        # only unregister if this Peer object still owns the slot — a stale
        # connection for a re-registered node_id must not evict the live one
        if self.peers.get(peer.node_id) is peer:
            self.peers.pop(peer.node_id, None)
            task = self._peer_tasks.pop(peer.node_id, None)
            if task is not None and task is not asyncio.current_task():
                task.cancel()
        peer.writer.close()
        log.info("peer %s dropped", peer.node_id[:12])

    # -- message pump -------------------------------------------------------

    async def _peer_loop(self, peer: Peer) -> None:
        try:
            while True:
                d = faults.hit("p2p.peer.recv", peer.node_id[:12],
                               faults.POINT)
                if d is not None and d.delay:
                    await asyncio.sleep(d.delay)
                frame = await read_frame(peer.reader)
                peer.last_seen = time.time()
                peer.messages_in += 1
                self.stats["messages_received"] += 1
                try:
                    msg = P2PMessage.decode_frame(frame)
                except ValueError as e:
                    log.warning("bad frame from %s: %s", peer.node_id[:12], e)
                    continue
                await self._handle(peer, msg)
        except (
            asyncio.IncompleteReadError, ConnectionError, ValueError,
            asyncio.CancelledError,
        ):
            pass
        finally:
            self._drop_peer(peer)

    def _dedup(self, message_id: str) -> bool:
        """True if already seen (and should be dropped)."""
        if not message_id:
            return False
        if message_id in self._seen:
            self.stats["messages_deduped"] += 1
            return True
        self._seen[message_id] = None
        while len(self._seen) > self.config.dedup_window:
            self._seen.popitem(last=False)
        return False

    async def _handle(self, peer: Peer, msg: P2PMessage) -> None:
        if msg.type == MessageType.PING:
            peer.send(P2PMessage(
                MessageType.PONG, {"nonce": msg.payload.get("nonce")},
                sender=self.node_id,
            ))
            return
        if msg.type == MessageType.PONG:
            sent = self._ping_sent.pop(peer.node_id, None)
            if sent is not None:
                peer.latency = time.time() - sent
            return
        if msg.type == MessageType.GET_PEERS:
            peer.send(P2PMessage(
                MessageType.PEER_LIST,
                {"peers": self.known_addresses(exclude=peer.node_id)},
                sender=self.node_id,
            ))
            return
        if msg.type == MessageType.PEER_LIST:
            await self._maybe_connect_new(msg.payload.get("peers", []))
            # fall through to user handler too, if any
        if self._dedup(msg.message_id):
            return
        handler = self.handlers.get(msg.type)
        if handler is not None:
            try:
                await handler(self, peer, msg)
            except Exception:
                log.exception("handler for %s failed", msg.type.name)

    # -- gossip -------------------------------------------------------------

    def on(self, mtype: MessageType, handler: Handler) -> None:
        self.handlers[mtype] = handler

    async def broadcast(
        self, msg: P2PMessage, exclude: str | None = None
    ) -> int:
        """Flood a message to all peers except ``exclude`` (origin).
        Marks the id as seen so our own flood doesn't bounce back in."""
        msg.sender = msg.sender or self.node_id
        self._dedup(msg.message_id)  # pre-mark
        sent: list[Peer] = []
        for peer in list(self.peers.values()):
            if peer.node_id == exclude:
                continue
            try:
                peer.send(msg)
                sent.append(peer)
            except (ConnectionError, RuntimeError):
                self._drop_peer(peer)
        self.stats["messages_sent"] += len(sent)
        # writer.drain on each would serialize; flush opportunistically —
        # but ONLY the peers this call actually wrote to: re-iterating
        # self.peers here would touch writers of peers registered since
        # (never written, pointless) and of peers dropped mid-broadcast
        # (drain on a closed transport raises into the gather)
        await asyncio.gather(
            *(p.writer.drain() for p in sent if not p.writer.is_closing()),
            return_exceptions=True,
        )
        return len(sent)

    async def propagate(self, peer: Peer, msg: P2PMessage) -> int:
        """Re-flood a received message to everyone but its origin."""
        return await self.broadcast(msg, exclude=peer.node_id)

    # -- discovery ----------------------------------------------------------

    def known_addresses(self, exclude: str | None = None) -> list[list]:
        out = []
        for p in self.peers.values():
            if p.node_id == exclude or not p.listen_port:
                continue
            host = p.addr.rsplit(":", 1)[0]
            out.append([host, p.listen_port, p.node_id])
        return out

    async def discover(self) -> None:
        """Ask every peer for their peers."""
        for peer in list(self.peers.values()):
            peer.send(P2PMessage(MessageType.GET_PEERS, {}, sender=self.node_id))

    async def _maybe_connect_new(self, addresses: list) -> None:
        # dial in the background: one unroutable advertised address must not
        # stall the advertising peer's message pump
        for entry in addresses:
            if len(self.peers) >= self.config.max_peers:
                return
            try:
                host, port, node_id = entry[0], int(entry[1]), str(entry[2])
            except (IndexError, ValueError, TypeError):
                continue
            if node_id == self.node_id or node_id in self.peers:
                continue
            self._tasks.append(asyncio.create_task(self._connect_quietly(host, port)))
        self._tasks = [t for t in self._tasks if not t.done()]

    async def _connect_quietly(self, host: str, port: int) -> None:
        key = (host, port)
        if key in self._dialing:
            return
        self._dialing.add(key)
        try:
            await self.connect(host, port)
        except (OSError, ConnectionError, asyncio.TimeoutError, ValueError):
            pass
        finally:
            self._dialing.discard(key)

    # -- keepalive ----------------------------------------------------------

    async def _keepalive_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.keepalive_seconds)
            now = time.time()
            for peer in list(self.peers.values()):
                if now - peer.last_seen > self.config.peer_timeout:
                    log.info("peer %s timed out", peer.node_id[:12])
                    self._drop_peer(peer)
                    continue
                self._ping_sent[peer.node_id] = now
                try:
                    peer.send(P2PMessage(
                        MessageType.PING, {"nonce": secrets.token_hex(4)},
                        sender=self.node_id,
                    ))
                except (ConnectionError, RuntimeError):
                    self._drop_peer(peer)

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "node_id": self.node_id,
            "listen": f"{self.config.host}:{self.config.port}",
            "peers": len(self.peers),
            **self.stats,
        }
