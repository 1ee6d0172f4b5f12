"""In-process P2P transport: thousands of nodes, zero sockets (counterpart
of ``otedama_tpu/p2p/memnet.py``, copied whole).

Reference parity: test/integration/p2p_integration_test.go:16-361 runs its
overlay nodes over loopback TCP; at the BASELINE config-5 scale (1024
devices) a socket per link is the bottleneck, not the protocol. This
module swaps only the BYTE TRANSPORT: each link is a pair of real
``asyncio.StreamReader``s cross-fed by lightweight writers, so the
production ``P2PNode`` peer loops, frame codec, dedup, gossip handlers and
ledger logic all run unchanged — exactly the code a real deployment runs,
minus the kernel's TCP stack.

Usage:
    net = MemoryNetwork()
    pools = [P2PPool(NodeConfig(max_peers=64)) for _ in range(1024)]
    for a, b in topology_edges:
        net.link(pools[a].node, pools[b].node)
    ... gossip flows; no start()/sockets involved ...
    await net.close()
"""

from __future__ import annotations

import asyncio

from otedama_tpu_torch.p2p.node import P2PNode, Peer
from otedama_tpu_torch.utils import faults


class MemoryWriter:
    """The subset of StreamWriter the node uses, feeding a remote reader."""

    def __init__(self, remote_reader: asyncio.StreamReader, label: str):
        self._remote = remote_reader
        self._label = label
        self._closed = False

    def write(self, data: bytes) -> None:
        if self._closed:
            return
        d = faults.hit("p2p.mem.send", self._label, faults.SEND_SYNC)
        if d is not None:
            if d.drop:
                return
            if d.truncate >= 0:
                # partial frame + EOF: the remote peer loop must treat it
                # as a dead link (IncompleteReadError), same as real TCP
                self._remote.feed_data(data[:d.truncate])
                self.close()
                return
        self._remote.feed_data(data)

    async def drain(self) -> None:
        # yield so fed readers get scheduled — keeps one chatty node from
        # starving the loop, mirroring TCP backpressure's effect
        await asyncio.sleep(0)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._remote.feed_eof()

    def is_closing(self) -> bool:
        return self._closed

    def get_extra_info(self, name, default=None):
        if name == "peername":
            return ("mem", self._label)
        return default


class MemoryNetwork:
    """Registry of in-memory links between live P2PNode instances."""

    def __init__(self):
        self._writers: list[MemoryWriter] = []
        self._nodes: set[int] = set()
        self._node_refs: list[P2PNode] = []

    def link(self, a: P2PNode, b: P2PNode) -> tuple[Peer, Peer]:
        """Create a bidirectional link; both nodes see a registered peer
        and their production peer loops start pumping frames."""
        reader_a = asyncio.StreamReader()  # bytes arriving AT a (from b)
        reader_b = asyncio.StreamReader()
        writer_a = MemoryWriter(reader_b, f"{b.node_id[:8]}")  # a -> b
        writer_b = MemoryWriter(reader_a, f"{a.node_id[:8]}")
        self._writers += [writer_a, writer_b]
        peer_at_a = a._register_peer(
            b.node_id, reader_a, writer_a, listen_port=0, outbound=True
        )
        peer_at_b = b._register_peer(
            a.node_id, reader_b, writer_b, listen_port=0, outbound=False
        )
        for n in (a, b):
            if id(n) not in self._nodes:
                self._nodes.add(id(n))
                self._node_refs.append(n)
        return peer_at_a, peer_at_b

    async def close(self) -> None:
        for w in self._writers:
            w.close()
        for n in self._node_refs:
            for t in list(n._peer_tasks.values()):
                t.cancel()
            await asyncio.gather(
                *n._peer_tasks.values(), return_exceptions=True
            )
            n._peer_tasks.clear()
            n.peers.clear()
        self._writers.clear()
        self._node_refs.clear()
        self._nodes.clear()


def ring_with_shortcuts(n: int, shortcuts_per_node: int = 2,
                        seed: int = 1234) -> list[tuple[int, int]]:
    """A connected, low-diameter gossip topology: ring + deterministic
    pseudo-random shortcuts (what real P2P discovery converges to)."""
    import random

    rng = random.Random(seed)
    # normalize every pair (incl. the wrap edge) so a shortcut landing on
    # an existing ring pair can't produce a duplicate link — double
    # _register_peer would orphan the first peer loop task
    edges = {(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)}
    for i in range(n):
        for _ in range(shortcuts_per_node):
            j = rng.randrange(n)
            if j != i:
                edges.add((min(i, j), max(i, j)))
    return sorted(edges)
