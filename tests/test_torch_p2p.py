"""Port parity, the P2P share-chain pool: ``tests/test_p2p.py``'s and
``tests/test_sharechain.py``'s cases through both packages (parametrised
``jax`` / ``torch``: the JAX package's ``p2p`` modules and the port's),
on the CPU, each under its package's own fault injector.

Then the packages against each other on numpy-seeded inputs with fixed
``ts_ms``: equal ``Share.to_payload()``, share ids and commitments;
frames encoded by one package decode in the other; equal tips, heights
and ``weights()`` after the same connect sequence, reorgs included; a
gossip overlay over the in-memory transport converging on the same tip
in both. And the port's own paths: ``submit_share_batch`` through
``ValidationBackend(device="cpu")`` (the plain verify kernel B2 on the
gossip path), no host re-verification when the validator raises
(ROADMAP Queue C 29), the refused chain store, and ``cli p2p --mine``
raising without a card.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import struct
import time
import types

import numpy as np
import pytest
import torch


def _package(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root, sc=mod("p2p.sharechain"), messages=mod("p2p.messages"),
        node=mod("p2p.node"), pool=mod("p2p.pool"), memnet=mod("p2p.memnet"),
        faults=mod("utils.faults"), pow_host=mod("utils.pow_host"),
        tgt=mod("kernels.target"), app=mod("app"), schema=mod("config.schema"),
    )


REF = _package("otedama_tpu")
PORT = _package("otedama_tpu_torch")
PACKAGES = pytest.mark.parametrize("m", [REF, PORT], ids=["jax", "torch"])

# easy enough that host-grinding a share is a few milliseconds, hard
# enough that the PoW check is real (digest must actually meet target)
TEST_D = 1e-6
TS_MS = 1_760_000_000_000


def params(m, **kw):
    base = dict(min_difficulty=TEST_D, window=64, max_reorg_depth=8,
                max_orphans=32, sync_page=3)
    base.update(kw)
    return m.sc.ChainParams(**base)


def overlay_params(m, **kw):
    """``tests/test_p2p.py``'s chain parameters."""
    base = dict(min_difficulty=TEST_D, window=256, max_reorg_depth=16)
    base.update(kw)
    return m.sc.ChainParams(**base)


def d_eff(m) -> float:
    return m.sc.effective_difficulty(TEST_D)


def mine_chain(m, n: int, worker: str = "w", prev: bytes | None = None,
               difficulty: float = TEST_D, ts_ms: int | None = None):
    prev = m.sc.GENESIS if prev is None else prev
    out = []
    for i in range(n):
        s = m.sc.mine_share(prev, worker, f"job{i}", difficulty, ts_ms=ts_ms)
        out.append(s)
        prev = s.share_id
    return out


def splits(pools) -> set:
    return {json.dumps(p.weights(), sort_keys=True) for p in pools}


async def _wait_for(cond, timeout=20.0, kick=None):
    """Poll until cond(); optionally fire ``kick`` (request_sync retries)
    every ~0.5 s so seeded message loss can never wedge the wait."""
    deadline = time.monotonic() + timeout
    i = 0
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met before timeout")
        if kick is not None and i % 25 == 24:
            await kick()
        i += 1
        await asyncio.sleep(0.02)


def _pin(m, i: int):
    return m.node.NodeConfig(node_id=f"{i + 0xA0:02x}" * 32)


# == tests/test_p2p.py ========================================================

@PACKAGES
def test_frame_roundtrip(m):
    msg = m.messages.P2PMessage(m.messages.MessageType.SHARE,
                                {"worker": "w", "difficulty": 2.5},
                                sender="ab" * 32)
    back = m.messages.P2PMessage.decode_frame(msg.encode()[8:])
    assert back.type == m.messages.MessageType.SHARE
    assert back.payload == msg.payload
    assert back.sender == msg.sender
    assert back.message_id == msg.message_id


@PACKAGES
@pytest.mark.asyncio
async def test_handshake_and_broadcast(m):
    NodeConfig, P2PNode = m.node.NodeConfig, m.node.P2PNode
    a, b = P2PNode(NodeConfig()), P2PNode(NodeConfig())
    received = []

    async def on_share(node, peer, msg):
        received.append(msg.payload)

    b.on(m.messages.MessageType.SHARE, on_share)
    await a.start()
    await b.start()
    try:
        await a.connect("127.0.0.1", b.port)
        await _wait_for(lambda: len(b.peers) == 1)
        assert a.peers and b.peers
        n = await a.broadcast(m.messages.P2PMessage(
            m.messages.MessageType.SHARE, {"v": 1}))
        assert n == 1
        await _wait_for(lambda: received)
        assert received == [{"v": 1}]
    finally:
        await a.stop()
        await b.stop()


@PACKAGES
@pytest.mark.asyncio
async def test_discovery_connects_mesh(m):
    """c bootstraps to a; a knows b; discovery links c to b."""
    NodeConfig, P2PNode = m.node.NodeConfig, m.node.P2PNode
    a = P2PNode(NodeConfig())
    await a.start()
    b = P2PNode(NodeConfig(bootstrap=[("127.0.0.1", 0)]))
    b.config.bootstrap = []
    await b.start()
    c = P2PNode(NodeConfig())
    await c.start()
    try:
        await b.connect("127.0.0.1", a.port)
        await c.connect("127.0.0.1", a.port)
        await _wait_for(lambda: len(a.peers) == 2)
        await c.discover()
        await _wait_for(lambda: len(c.peers) == 2)
        assert b.node_id in c.peers
    finally:
        for n in (a, b, c):
            await n.stop()


@PACKAGES
@pytest.mark.asyncio
async def test_flood_dedup_no_storm(m):
    """A triangle of peers must not re-flood a message forever."""
    nodes = [m.node.P2PNode(m.node.NodeConfig()) for _ in range(3)]
    counts = [0, 0, 0]

    def make_handler(i):
        async def h(node, peer, msg):
            counts[i] += 1
            await node.propagate(peer, msg)
        return h

    for i, n in enumerate(nodes):
        n.on(m.messages.MessageType.BLOCK, make_handler(i))
        await n.start()
    try:
        await nodes[0].connect("127.0.0.1", nodes[1].port)
        await nodes[0].connect("127.0.0.1", nodes[2].port)
        await nodes[1].connect("127.0.0.1", nodes[2].port)
        await _wait_for(lambda: all(len(n.peers) == 2 for n in nodes))
        await nodes[0].broadcast(m.messages.P2PMessage(
            m.messages.MessageType.BLOCK, {"h": "x"}))
        await _wait_for(lambda: counts[1] >= 1 and counts[2] >= 1)
        await asyncio.sleep(0.3)  # give a storm time to manifest if any
        assert counts == [0, 1, 1]
        assert sum(n.stats["messages_deduped"] for n in nodes) >= 1
    finally:
        for n in nodes:
            await n.stop()


@PACKAGES
@pytest.mark.asyncio
async def test_broadcast_drains_only_sent_peers(m):
    """The post-send drain touches only peers this broadcast wrote to."""

    class Writer:
        def __init__(self, fail_send=False):
            self.fail_send = fail_send
            self.drains = 0
            self.closed = False

        def write(self, data):
            if self.fail_send:
                raise ConnectionError("boom")

        async def drain(self):
            assert not self.closed, "drained a closed transport"
            self.drains += 1

        def close(self):
            self.closed = True

        def is_closing(self):
            return self.closed

    node = m.node.P2PNode(m.node.NodeConfig())

    def fake_peer(pid, writer):
        node.peers[pid] = m.node.Peer(
            node_id=pid, addr="?", listen_port=0,
            reader=asyncio.StreamReader(), writer=writer, outbound=True)

    good, bad = Writer(), Writer(fail_send=True)
    fake_peer("aa" * 32, good)
    fake_peer("bb" * 32, bad)
    n = await node.broadcast(m.messages.P2PMessage(
        m.messages.MessageType.BLOCK, {"x": 1}))
    assert n == 1
    assert good.drains == 1
    assert bad.drains == 0 and bad.closed   # dropped, never drained
    assert "bb" * 32 not in node.peers


@PACKAGES
@pytest.mark.asyncio
async def test_stop_closes_transports_and_cancels_dials(m):
    """Repeated start/stop must not leak transports: stop() awaits
    wait_closed() on every peer writer and cancels in-flight dials."""
    NodeConfig, P2PNode = m.node.NodeConfig, m.node.P2PNode
    for _ in range(3):
        a, b = P2PNode(NodeConfig()), P2PNode(NodeConfig())
        await a.start()
        await b.start()
        await a.connect("127.0.0.1", b.port)
        await _wait_for(lambda: len(b.peers) == 1)
        writers = [p.writer for p in a.peers.values()]
        writers += [p.writer for p in b.peers.values()]
        a._tasks.append(asyncio.create_task(
            a._connect_quietly("10.255.255.1", 1)))
        await a.stop()
        await b.stop()
        for w in writers:
            assert w.is_closing()
            await asyncio.wait_for(w.wait_closed(), 1.0)
        assert not a._tasks and not a._dialing
        assert not a.peers and not b.peers


@pytest.mark.asyncio
async def test_port_stop_closes_a_handshake_in_flight():
    """A connection accepted whose handshake never comes: the port's
    ``stop()`` closes it before it waits for the listener, so on Python
    3.12 the stop does not wait out the 10 s handshake timeout."""
    node = PORT.node.P2PNode(PORT.node.NodeConfig())
    await node.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", node.port)
    await _wait_for(lambda: node._handshaking, 5.0)
    t0 = time.monotonic()
    await node.stop()
    assert time.monotonic() - t0 < 2.0 and not node._handshaking
    assert await asyncio.wait_for(reader.read(), 2.0) == b""
    writer.close()


@PACKAGES
@pytest.mark.asyncio
async def test_p2p_pool_chain_convergence(m):
    """Shares mined on different nodes land on one chain with identical
    PPLNS weights on every node; a late joiner catches up via locator
    sync (shares carry real PoW — claimed difficulty is verified)."""
    p = overlay_params(m)
    P2PPool, NodeConfig = m.pool.P2PPool, m.node.NodeConfig
    pools = [P2PPool(NodeConfig(), p) for _ in range(3)]
    for pool in pools:
        await pool.start()
    try:
        await pools[0].node.connect("127.0.0.1", pools[1].node.port)
        await pools[1].node.connect("127.0.0.1", pools[2].node.port)
        await pools[0].node.connect("127.0.0.1", pools[2].node.port)
        await _wait_for(lambda: all(len(q.node.peers) == 2 for q in pools))
        await pools[0].announce_share("alice", 2 * TEST_D, "j1")
        await _wait_for(lambda: all(q.chain.height == 1 for q in pools))
        await pools[1].announce_share("bob", 3 * TEST_D, "j1")
        await _wait_for(lambda: all(q.chain.height == 2 for q in pools))
        await pools[2].announce_share("alice", TEST_D, "j1")
        await _wait_for(lambda: all(q.chain.height == 3 for q in pools))

        seen = splits(pools)
        assert len(seen) == 1
        w = pools[0].weights()
        assert w["alice"] == pytest.approx(
            m.sc.effective_difficulty(2 * TEST_D) + d_eff(m))
        assert w["bob"] == pytest.approx(m.sc.effective_difficulty(3 * TEST_D))

        await pools[1].announce_block("00ff", "bob", 101)
        await _wait_for(lambda: all(len(q.blocks_seen) == 1 for q in pools))

        late = P2PPool(NodeConfig(), p)
        await late.start()
        try:
            await late.node.connect("127.0.0.1", pools[0].node.port)
            await late.request_sync()
            await _wait_for(lambda: late.chain.height == 3)
            assert late.chain.tip == pools[0].chain.tip
            assert json.dumps(late.weights(), sort_keys=True) in seen
        finally:
            await late.stop()
    finally:
        for pool in pools:
            await pool.stop()


async def _overlay_sim(m, n: int, shares: list, solo_a, solo_b):
    """``tests/test_p2p.py``'s 1,024-node simulation at ``n`` nodes: the
    production node and pool code over the in-memory transport; ten
    shares from node 0, then one each from two other nodes once they hold
    the flooded tip. The shares are mined beforehand (fixed ``ts_ms``),
    so both packages see the same bytes."""
    p = overlay_params(m, window=64)
    pools = [m.pool.P2PPool(m.node.NodeConfig(max_peers=64, dedup_window=8192),
                            p) for _ in range(n)]
    net = m.memnet.MemoryNetwork()
    for a, b in m.memnet.ring_with_shortcuts(n, shortcuts_per_node=2):
        net.link(pools[a].node, pools[b].node)
    far, farther = n // 60 + 1, (n * 7) // 8

    async def converge(height, subset, timeout):
        await _wait_for(lambda: all(q.chain.height >= height for q in subset),
                        timeout)

    try:
        for s in shares:
            assert await pools[0].submit_share(s) == "accepted"
        await converge(10, [pools[far], pools[farther]], 60.0)
        sa = solo_a(pools[far].chain.tip)
        assert await pools[far].submit_share(sa) == "accepted"
        await converge(11, [pools[farther]], 60.0)
        sb = solo_b(pools[farther].chain.tip)
        assert await pools[farther].submit_share(sb) == "accepted"
        await converge(12, pools, 90.0)
        heights = sorted(q.chain.height for q in pools)
        assert heights[0] == heights[-1] == 12
        assert len({q.chain.tip for q in pools}) == 1
        assert len(splits(pools)) == 1
        w = pools[0].weights()
        assert w["tpu-pod"] == pytest.approx(10 * d_eff(m))
        assert w["solo-a"] == pytest.approx(d_eff(m))
        assert w["solo-b"] == pytest.approx(d_eff(m))
        assert sum(q.node.stats["messages_deduped"] for q in pools) > 0
        assert all(q.stats["shares_rejected"] == 0 for q in pools)
        assert all(q.chain.shares_connected == 12 for q in pools[1:])
        return pools[0].chain.tip, w
    finally:
        await net.close()


@pytest.mark.asyncio
async def test_overlay_pool_sim_converges_equally_in_both_packages():
    """The 1,024-node simulation, cut to 192 nodes so that both packages
    together take seconds: one seed, the same shares, equal final tips
    and weights."""
    n = 192
    pod = mine_chain(PORT, 10, "tpu-pod", ts_ms=TS_MS)
    results = []
    for m in (REF, PORT):
        shares = [m.sc.Share.from_payload(s.to_payload()) for s in pod]

        def solo(worker, job):
            return lambda tip, m=m: m.sc.mine_share(tip, worker, job, TEST_D,
                                                    ts_ms=TS_MS)

        results.append(await _overlay_sim(m, n, shares, solo("solo-a", "job-a"),
                                          solo("solo-b", "job-b")))
    assert results[0] == results[1]


# == tests/test_sharechain.py =================================================

@PACKAGES
def test_mine_verify_roundtrip_and_payload(m):
    s = m.sc.mine_share(m.sc.GENESIS, "alice", "j1", TEST_D)
    m.sc.verify_share(s, params(m))
    assert s.prev_hash == m.sc.GENESIS
    assert s.difficulty == pytest.approx(TEST_D, rel=1e-3)
    back = m.sc.Share.from_payload(json.loads(json.dumps(s.to_payload())))
    assert back.share_id == s.share_id
    m.sc.verify_share(back, params(m))


@PACKAGES
def test_reassigned_worker_fails_commitment(m):
    s = m.sc.mine_share(m.sc.GENESIS, "alice", "j1", TEST_D)
    stolen = m.sc.Share(s.header, "mallory", s.job_id, s.ts_ms)
    with pytest.raises(m.sc.ShareInvalid) as e:
        m.sc.verify_share(stolen, params(m))
    assert e.value.reason == "commitment"


def _inflated(m, s):
    """``s`` claiming a target 512x harder than its digest meets."""
    digest = m.pow_host.pow_digest(s.header)
    hdr = bytearray(s.header)
    hdr[72:76] = struct.pack("<I", m.tgt.target_to_bits(
        int.from_bytes(digest, "little") >> 9))
    return m.sc.Share(bytes(hdr), s.worker, s.job_id, s.ts_ms)


@PACKAGES
def test_inflated_difficulty_claim_fails_pow(m):
    s = m.sc.mine_share(m.sc.GENESIS, "alice", "j1", TEST_D)
    with pytest.raises(m.sc.ShareInvalid) as e:
        m.sc.verify_share(_inflated(m, s), params(m))
    assert e.value.reason == "pow"


@PACKAGES
def test_below_minimum_difficulty_rejected(m):
    easy = m.sc.mine_share(m.sc.GENESIS, "alice", "j1", TEST_D / 64)
    with pytest.raises(m.sc.ShareInvalid) as e:
        m.sc.verify_share(easy, params(m, min_difficulty=TEST_D))
    assert e.value.reason == "difficulty"


@PACKAGES
def test_wrong_algorithm_rejected(m):
    s = m.sc.mine_share(m.sc.GENESIS, "alice", "j1", TEST_D)
    with pytest.raises(m.sc.ShareInvalid) as e:
        m.sc.verify_share(s, params(m, algorithm="scrypt"))
    assert e.value.reason == "algorithm"


@PACKAGES
def test_timestamp_skew_future_rejected_past_normalized(m):
    p = params(m, max_time_skew=300.0)
    now = time.time()
    future = m.sc.mine_share(m.sc.GENESIS, "a", "j", TEST_D,
                             ts_ms=int((now + 3600) * 1000))
    with pytest.raises(m.sc.ShareInvalid) as e:
        m.sc.verify_share(future, p, now=now)
    assert e.value.reason == "time-future"
    old = m.sc.mine_share(m.sc.GENESIS, "a", "j", TEST_D, ts_ms=1000)
    m.sc.verify_share(old, p, now=now)
    assert m.sc.clamp_timestamp(old.ts_ms, now, 300.0) == pytest.approx(1.0)
    assert m.sc.clamp_timestamp(int((now + 9e6) * 1000), now, 300.0) == (
        pytest.approx(now + 300.0))


@PACKAGES
def test_malformed_payloads_raise_format_error(m):
    for bad in (
        "not a dict",
        {},
        {"header": "zz", "worker": "w", "job_id": "j", "ts_ms": 0},
        {"header": "ab" * 79, "worker": "w", "job_id": "j", "ts_ms": 0},
        {"header": "ab" * 80, "worker": "", "job_id": "j", "ts_ms": 0},
        {"header": "ab" * 80, "worker": "w", "job_id": "j", "ts_ms": -5},
        {"header": "ab" * 80, "worker": "w", "job_id": "j", "ts_ms": 1 << 64},
        {"header": "ab" * 80, "worker": "w", "job_id": "j", "ts_ms": 0,
         "block_number": 1 << 40},
        {"header": "ab" * 80, "worker": "w" * 200, "job_id": "j", "ts_ms": 0},
    ):
        with pytest.raises(m.sc.ShareFormatError):
            m.sc.Share.from_payload(bad)


@PACKAGES
def test_orphans_link_when_parent_arrives(m):
    chain = m.sc.ShareChain(params(m))
    a, b, c = mine_chain(m, 3)
    assert chain.connect(c) == "orphan"
    assert chain.connect(b) == "orphan"
    assert chain.height == 0
    assert chain.connect(a) == "accepted"
    assert chain.height == 3
    assert chain.tip == c.share_id
    assert chain.orphans_adopted == 2 and not chain.orphans


@PACKAGES
def test_orphan_pool_bounded(m):
    chain = m.sc.ShareChain(params(m, max_orphans=4))
    for i in range(6):
        s = m.sc.mine_share(b"\x11" * 32, "w", f"j{i}", TEST_D)
        assert chain.connect(s) == "orphan"
    assert len(chain.orphans) == 4
    assert chain.orphans_evicted == 2


@PACKAGES
def test_fork_choice_heaviest_work_and_deterministic_tie(m):
    chain = m.sc.ShareChain(params(m))
    main = mine_chain(m, 3, "main")
    for s in main:
        chain.connect(s)
    side = mine_chain(m, 2, "side")
    for s in side:
        chain.connect(s)
    assert chain.tip == main[-1].share_id
    tie = m.sc.mine_share(main[1].share_id, "tie", "jt", TEST_D)
    chain.connect(tie)
    assert chain.tip == min(tie.share_id, main[-1].share_id)
    other = m.sc.ShareChain(params(m))
    for s in main + side + [tie]:
        other.connect(s)
    assert other.tip == chain.tip
    assert json.dumps(other.weights(), sort_keys=True) == (
        json.dumps(chain.weights(), sort_keys=True))


@PACKAGES
def test_reorg_rewinds_and_replays_window(m):
    chain = m.sc.ShareChain(params(m))
    base = mine_chain(m, 2, "base")
    for s in base:
        chain.connect(s)
    a_side = mine_chain(m, 2, "a", prev=base[-1].share_id)
    for s in a_side:
        chain.connect(s)
    assert chain.tip == a_side[-1].share_id
    assert chain.weights()["a"] == pytest.approx(2 * d_eff(m))
    b_side = mine_chain(m, 3, "b", prev=base[-1].share_id)
    for s in b_side:
        chain.connect(s)
    assert chain.tip == b_side[-1].share_id
    assert chain.reorgs == 1 and chain.deepest_reorg == 2
    w = chain.weights()
    assert "a" not in w
    assert w["b"] == pytest.approx(3 * d_eff(m))
    assert w["base"] == pytest.approx(2 * d_eff(m))


@PACKAGES
def test_reorg_deeper_than_limit_refused(m):
    chain = m.sc.ShareChain(params(m, max_reorg_depth=2))
    main = mine_chain(m, 4, "main")
    for s in main:
        chain.connect(s)
    for s in mine_chain(m, 6, "heavy"):
        chain.connect(s)
    assert chain.tip == main[-1].share_id
    assert chain.reorgs_refused >= 1 and chain.reorgs == 0


@PACKAGES
def test_pplns_window_bounds_weights(m):
    chain = m.sc.ShareChain(params(m, window=3))
    for s in mine_chain(m, 5, "w"):
        chain.connect(s)
    assert chain.weights()["w"] == pytest.approx(3 * d_eff(m))


@PACKAGES
def test_prune_side_branches_keeps_best_chain(m):
    chain = m.sc.ShareChain(params(m, max_reorg_depth=2))
    main = mine_chain(m, 8, "main")
    for s in main:
        chain.connect(s)
    side = mine_chain(m, 1, "side")
    chain.connect(side[0])
    assert chain.prune_side_branches() == 1
    assert side[0].share_id not in chain.records
    assert chain.height == 8 and all(
        s.share_id in chain.records for s in main)


@PACKAGES
def test_locator_shape_and_paged_sync(m):
    src = m.sc.ShareChain(params(m, sync_page=4))
    shares = mine_chain(m, 23, "w")
    for s in shares:
        src.connect(s)
    loc = src.locator()
    assert loc[0] == src.tip.hex()
    assert loc[-1] == shares[0].share_id.hex()
    assert len(loc) < 23
    assert m.messages.parse_locator(loc) == loc
    dst = m.sc.ShareChain(params(m, sync_page=4))
    pages = 0
    while True:
        page, more = src.shares_after(dst.locator())
        assert len(page) <= 4
        for s in page:
            dst.connect(s)
        pages += 1
        if not more:
            break
    assert dst.tip == src.tip and dst.height == 23
    assert pages >= 6
    assert json.dumps(dst.weights(), sort_keys=True) == (
        json.dumps(src.weights(), sort_keys=True))


@PACKAGES
def test_sync_from_diverged_fork_finds_common_ancestor(m):
    src, dst = m.sc.ShareChain(params(m)), m.sc.ShareChain(params(m))
    base = mine_chain(m, 3, "base")
    for s in base:
        src.connect(s)
        dst.connect(s)
    for s in mine_chain(m, 4, "src", prev=base[-1].share_id):
        src.connect(s)
    for s in mine_chain(m, 2, "dst", prev=base[-1].share_id):
        dst.connect(s)
    page, more = src.shares_after(dst.locator(), 100)
    assert len(page) == 4 and not more
    assert page[0].prev_hash == base[-1].share_id
    for s in page:
        dst.connect(s)
    assert dst.tip == src.tip
    assert dst.deepest_reorg == 2


@PACKAGES
@pytest.mark.asyncio
async def test_share_verify_fault_drop_recovers_via_orphan_sync(m):
    """A dropped verification loses a share on one node; the next share
    arrives as an orphan and triggers locator sync, which restores the
    missing parent (seeded on ``p2p.share.verify``)."""
    p = params(m)
    a, b = m.pool.P2PPool(_pin(m, 0), p), m.pool.P2PPool(_pin(m, 1), p)
    net = m.memnet.MemoryNetwork()
    net.link(a.node, b.node)
    inj = m.faults.FaultInjector(seed=901).drop("p2p.share.verify", once=True)
    try:
        with m.faults.active(inj):
            await a.announce_share("alice", TEST_D, "j0")
            await _wait_for(lambda: b.stats["verify_failures"] == 1)
            assert b.chain.height == 0
        await a.announce_share("alice", TEST_D, "j1")
        await _wait_for(lambda: b.chain.height == 2)
        assert b.chain.orphans_adopted >= 1
        assert splits([a, b]) == {json.dumps(a.weights(), sort_keys=True)}
        assert inj.snapshot()["rules"][0]["fires"] == 1
    finally:
        await net.close()


@PACKAGES
@pytest.mark.asyncio
async def test_truncated_send_kills_link_sync_heals(m):
    """A truncated frame (``p2p.peer.send``) kills the link mid-gossip;
    after re-linking, locator sync restores convergence."""
    p = params(m)
    a, b = m.pool.P2PPool(_pin(m, 2), p), m.pool.P2PPool(_pin(m, 3), p)
    net = m.memnet.MemoryNetwork()
    net.link(a.node, b.node)
    inj = m.faults.FaultInjector(seed=902).truncate(
        f"p2p.peer.send:{b.node.node_id[:12]}", keep_bytes=5, once=True)
    try:
        with m.faults.active(inj):
            await a.announce_share("alice", TEST_D, "j0")
        await _wait_for(lambda: not a.node.peers and not b.node.peers)
        assert b.chain.height == 0
        net.link(a.node, b.node)
        await b.request_sync()
        await _wait_for(lambda: b.chain.height == 1,
                        kick=lambda: b.request_sync())
        assert b.chain.tip == a.chain.tip
    finally:
        await net.close()


@PACKAGES
@pytest.mark.asyncio
async def test_4node_byzantine_partition_heal_converges_identically(m):
    """Byzantine shares (a stolen claim, an inflated difficulty) never
    enter or leave an honest chain, even across a partition heal; after
    divergent mining on both sides of a partition all four nodes converge
    on the heavier chain (a 2-deep reorg on the losing side) with
    byte-identical weights. Seeded drops on ``p2p.peer.send`` and
    ``p2p.sync`` throughout."""
    sc, MT, Msg = m.sc, m.messages.MessageType, m.messages.P2PMessage
    p = params(m, max_reorg_depth=8)
    pools = [m.pool.P2PPool(_pin(m, i), p) for i in range(4)]
    net = m.memnet.MemoryNetwork()
    links = {}
    for i in range(4):
        for j in range(i + 1, 4):
            links[(i, j)] = net.link(pools[i].node, pools[j].node)

    async def kick_all():
        for pool in pools:
            await pool.request_sync()

    def heights(group):
        return [pools[i].chain.height for i in group]

    inj = (m.faults.FaultInjector(seed=4242)
           .drop("p2p.peer.send", probability=0.10)
           .drop("p2p.sync", probability=0.25))
    try:
        with m.faults.active(inj):
            await pools[0].announce_share("alice", 2 * TEST_D, "jA")
            await _wait_for(lambda: min(heights(range(4))) == 1, kick=kick_all)
            await pools[1].announce_share("bob", 3 * TEST_D, "jB")
            await _wait_for(lambda: min(heights(range(4))) == 2, kick=kick_all)

            honest = sc.mine_share(pools[3].chain.tip, "evil", "jE", TEST_D)
            stolen = sc.Share(honest.header, "mallory", honest.job_id,
                              honest.ts_ms)
            await pools[3].node.broadcast(Msg(MT.SHARE, stolen.to_payload()))
            await _wait_for(lambda: all(
                pool.rejects.get("commitment", 0) >= 1
                for pool in pools[:3]), kick=kick_all)
            assert all(stolen.share_id not in pool.chain for pool in pools)
            assert all(pool.chain.height == 2 for pool in pools)

            for (i, j), (pa, pb) in links.items():
                if (i < 2) != (j < 2):
                    pa.writer.close()
                    pb.writer.close()
            await _wait_for(lambda: all(
                len(pool.node.peers) == 1 for pool in pools))
            for k in range(2):
                await pools[0].announce_share("a-side", TEST_D, f"ja{k}")
                await _wait_for(lambda k=k: min(heights((0, 1))) == 3 + k,
                                kick=lambda: pools[1].request_sync())
            for k in range(4):
                await pools[2].announce_share("b-side", TEST_D, f"jb{k}")
                await _wait_for(lambda k=k: min(heights((2, 3))) == 3 + k,
                                kick=lambda: pools[3].request_sync())
            assert pools[0].chain.tip != pools[2].chain.tip
            assert pools[0].chain.records[pools[0].chain.tip].cumwork < (
                pools[2].chain.records[pools[2].chain.tip].cumwork)

            inflated = _inflated(m, sc.mine_share(pools[3].chain.tip, "evil",
                                                  "jI", TEST_D))
            await pools[3].node.broadcast(Msg(MT.SHARE, inflated.to_payload()))
            await _wait_for(lambda: pools[2].rejects.get("pow", 0) >= 1)

            for i in range(2):
                for j in range(2, 4):
                    net.link(pools[i].node, pools[j].node)
            await _wait_for(lambda: all(
                len(pool.node.peers) == 3 for pool in pools))
            await kick_all()
            await _wait_for(
                lambda: len({pool.chain.tip for pool in pools}) == 1,
                timeout=30.0, kick=kick_all)

            assert pools[0].chain.tip == pools[2].chain.tip
            assert all(pool.chain.height == 6 for pool in pools)
            for i in (0, 1):
                assert pools[i].chain.reorgs >= 1
                assert pools[i].chain.deepest_reorg == 2
            assert len(splits(pools)) == 1
            w = pools[0].weights()
            assert w["b-side"] == pytest.approx(4 * d_eff(m))
            assert "a-side" not in w or w["a-side"] == 0.0
            assert w["alice"] == pytest.approx(
                sc.effective_difficulty(2 * TEST_D))
            assert w["bob"] == pytest.approx(sc.effective_difficulty(3 * TEST_D))
            for pool in pools:
                assert stolen.share_id not in pool.chain
                assert inflated.share_id not in pool.chain
            for i in (0, 1):
                assert pools[i].rejects.get("pow", 0) == 0
        fired = {r["point"]: r["fires"] for r in inj.snapshot()["rules"]}
        assert fired["p2p.peer.send"] > 0
        assert fired["p2p.sync"] > 0
    finally:
        await net.close()


@PACKAGES
@pytest.mark.asyncio
async def test_byzantine_empty_more_page_does_not_loop(m):
    """A peer answering {"shares": [], "more": true} must not drive an
    unbounded sync ping-pong."""
    p = params(m)
    a, b = m.pool.P2PPool(_pin(m, 12), p), m.pool.P2PPool(_pin(m, 13), p)
    net = m.memnet.MemoryNetwork()
    _, peer_at_b = net.link(a.node, b.node)
    try:
        for _ in range(2):
            peer_at_b.send(m.messages.P2PMessage(
                m.messages.MessageType.SYNC_RESPONSE,
                {"shares": [], "more": True}, sender=b.node.node_id))
        await asyncio.sleep(0.3)
        assert a.stats["sync_pages_received"] == 2
        assert b.stats["sync_requests"] == 0
    finally:
        await net.close()


@PACKAGES
@pytest.mark.asyncio
async def test_local_announce_enforces_min_difficulty(m):
    pool = m.pool.P2PPool(_pin(m, 9), params(m))
    with pytest.raises(ValueError):
        await pool.announce_share("w", TEST_D / 10, "j")


@PACKAGES
@pytest.mark.asyncio
async def test_app_p2p_mode_runs_the_chain(m):
    """``p2p.enabled`` wires the share chain from config (consensus
    parameters included), and two app nodes converge over real sockets
    through the bootstrap path. The port's app runs with
    ``mining.device`` and its validator on the CPU."""

    def make_cfg():
        cfg = m.schema.AppConfig()
        cfg.mining.enabled = False
        if m is REF:
            cfg.api.enabled = False
        else:
            cfg.mining.device = "cpu"
            cfg.validation.enabled = True
        cfg.p2p.enabled = True
        cfg.p2p.host = "127.0.0.1"
        cfg.p2p.port = 0
        cfg.p2p.share_difficulty = TEST_D
        cfg.p2p.pplns_window = 32
        cfg.p2p.max_reorg_depth = 4
        assert m.schema.validate_config(cfg) == []
        return cfg

    app_a = m.app.Application(make_cfg())
    await app_a.start()
    try:
        chain = app_a.p2p.chain
        assert chain.params.min_difficulty == TEST_D
        assert chain.params.window == 32
        assert chain.params.max_reorg_depth == 4
        assert chain.params.algorithm == "sha256d"
        if m is PORT:
            assert app_a.p2p.validator is app_a.validator
            assert app_a.validator.device == torch.device("cpu")
        cfg_b = make_cfg()
        cfg_b.p2p.bootstrap = [f"127.0.0.1:{app_a.p2p.node.port}"]
        app_b = m.app.Application(cfg_b)
        await app_b.start()
        try:
            await _wait_for(lambda: len(app_a.p2p.node.peers) == 1)
            await app_a.p2p.announce_share("w", TEST_D, "j0")
            await _wait_for(lambda: app_b.p2p.chain.height == 1)
            assert app_b.p2p.chain.tip == app_a.p2p.chain.tip
            assert app_a.snapshot()["p2p"]["chain"]["height"] == 1
        finally:
            await app_b.stop()
    finally:
        await app_a.stop()


@PACKAGES
@pytest.mark.asyncio
async def test_snapshot_and_metrics_export(m):
    """The pool's snapshot, rendered through each package's own API
    metrics; the port's snapshot is held to the reference's keys."""
    p = params(m)
    a, b = m.pool.P2PPool(_pin(m, 10), p), m.pool.P2PPool(_pin(m, 11), p)
    net = m.memnet.MemoryNetwork()
    net.link(a.node, b.node)
    try:
        await a.announce_share("alice", TEST_D, "j0")
        await _wait_for(lambda: b.chain.height == 1)
        snap = a.snapshot()
        assert snap["chain"]["height"] == 1
        assert snap["chain"]["tip"] == a.chain.tip.hex()
        assert snap["chain"]["tip_work"] > 0
        assert snap["shares_accepted"] == 1
        server = importlib.import_module(f"{m.root}.api.server")
        api = server.ApiServer()
        api.sync_p2p_metrics(snap)
        text = api.registry.render()
        assert "otedama_p2p_chain_height 1" in text
        assert "otedama_p2p_shares_connected_total 1" in text
        assert "otedama_p2p_tip_work" in text
        if m is PORT:
            ref = REF.pool.P2PPool(_pin(REF, 10), params(REF))
            assert set(snap) == set(ref.snapshot())
            assert set(snap["chain"]) == set(ref.snapshot()["chain"])
    finally:
        await net.close()


# == the packages against each other ==========================================

def _claims(seed: int, n: int):
    rng = np.random.default_rng(seed)
    algos = ["sha256d", "scrypt", "ethash", "sha256d"]
    for _ in range(n):
        worker = "w." + "".join(rng.choice(list("abcxyz09._-"),
                                           size=int(rng.integers(1, 40))))
        job = f"job-{int(rng.integers(0, 1 << 40)):x}"
        yield (worker, job, int(rng.integers(0, 1 << 62)),
               algos[int(rng.integers(0, 4))], int(rng.integers(0, 1 << 31)))


def test_share_bytes_and_commitments_equal_reference():
    for worker, job, ts_ms, algo, block in _claims(7, 64):
        assert PORT.sc.commitment(worker, job, ts_ms, algo, block) == \
            REF.sc.commitment(worker, job, ts_ms, algo, block)
    prev = PORT.sc.GENESIS
    for worker, job, ts_ms, _, _ in _claims(8, 12):
        ts_ms %= 1 << 40
        s = PORT.sc.mine_share(prev, worker, job, TEST_D, ts_ms=ts_ms)
        r = REF.sc.mine_share(prev, worker, job, TEST_D, ts_ms=ts_ms)
        assert s.to_payload() == r.to_payload()
        assert s.share_id == r.share_id and s.work == r.work
        assert PORT.sc.weight_units(s.target) == REF.sc.weight_units(r.target)
        PORT.sc.verify_share(s, params(PORT), now=ts_ms / 1000)
        prev = s.share_id
    for d in (1e-9, 1e-8, 3e-7, 1.0, 2.5e3):
        assert PORT.sc.effective_difficulty(d) == REF.sc.effective_difficulty(d)


def test_frames_decode_across_packages():
    rng = np.random.default_rng(11)
    for mtype in PORT.messages.MessageType:
        payload = {"shares": [{"header": rng.bytes(80).hex(), "n": i}
                              for i in range(int(rng.integers(0, 4)))],
                   "locator": [rng.bytes(32).hex()], "more": True}
        for enc, dec in ((PORT, REF), (REF, PORT)):
            msg = enc.messages.P2PMessage(
                enc.messages.MessageType(int(mtype)), payload,
                sender=rng.bytes(32).hex())
            frame = msg.encode()
            back = dec.messages.P2PMessage.decode_frame(frame[8:])
            assert (int(back.type), back.payload, back.sender,
                    back.message_id, back.timestamp) == (
                int(msg.type), msg.payload, msg.sender, msg.message_id,
                msg.timestamp)
            assert dec.messages.P2PMessage(
                back.type, back.payload, back.sender, back.message_id,
                back.timestamp).encode() == frame
    assert (PORT.messages.MAX_FRAME, PORT.messages.MAX_SYNC_PAGE,
            PORT.messages.MAX_SHARE_BATCH) == (
        REF.messages.MAX_FRAME, REF.messages.MAX_SYNC_PAGE,
        REF.messages.MAX_SHARE_BATCH) == (4 << 20, 500, 500)


def _share_dag(seed: int) -> list:
    """A seeded share DAG in a seeded connect order: a main line whose
    first ten shares arrive shuffled (orphans before their parents), a
    fork that wins (a 2-deep reorg), the main line winning back (4 deep),
    a fork from genesis too deep to adopt, a 4x-difficulty share that
    outweighs a longer branch, and duplicates."""
    rng = np.random.default_rng(seed)
    sc = PORT.sc
    main = mine_chain(PORT, 14, "main", ts_ms=TS_MS + seed)
    fork = mine_chain(PORT, 4, "fork", prev=main[7].share_id,
                      ts_ms=TS_MS + seed)
    deep = mine_chain(PORT, 17, "deep", ts_ms=TS_MS + seed)
    side = mine_chain(PORT, 2, "side", prev=main[11].share_id,
                      ts_ms=TS_MS + seed)
    heavy = sc.mine_share(main[12].share_id, "heavy", "jh", 4 * TEST_D,
                          ts_ms=TS_MS + seed)
    head = [main[int(i)] for i in rng.permutation(10)]
    return (head + fork + main[10:] + deep + side + [heavy]
            + [main[int(i)] for i in rng.integers(0, 14, size=3)])


def test_connect_sequence_gives_equal_tips_heights_and_weights():
    for seed in (1, 2, 3):
        seq = _share_dag(seed)
        chains = [m.sc.ShareChain(params(m, window=9, max_reorg_depth=4,
                                         max_orphans=64)) for m in (REF, PORT)]
        for s in seq:
            statuses = [c.connect(m.sc.Share.from_payload(s.to_payload()))
                        for m, c in zip((REF, PORT), chains)]
            assert statuses[0] == statuses[1]
            ref, port = chains
            assert (port.tip, port.height, port.tip_work, port.weights(),
                    port.locator()) == (ref.tip, ref.height, ref.tip_work,
                                        ref.weights(), ref.locator())
        ref, port = chains
        assert port.weights() == port.weights_full() == ref.weights_full()
        assert port.reorgs == ref.reorgs > 0
        assert port.deepest_reorg == ref.deepest_reorg
        assert port.reorgs_refused == ref.reorgs_refused > 0
        assert port.snapshot() == ref.snapshot()
        assert port.prune_side_branches() == ref.prune_side_branches()
        assert [s.share_id for s in port.chain_slice(0, port.height)] == \
            [s.share_id for s in ref.chain_slice(0, ref.height)]


def test_fault_points_equal_reference():
    for point in ("p2p.peer.send", "p2p.peer.recv", "p2p.mem.send",
                  "p2p.share.verify", "p2p.sync"):
        port, ref = PORT.faults.REGISTRY[point], REF.faults.REGISTRY[point]
        assert (port.location, port.tag, port.supports) == (
            ref.location, ref.tag, ref.supports)


# == the port's own paths =====================================================

@pytest.mark.asyncio
async def test_p2p_batch_verification_matches_per_share_path():
    """``tests/test_validation.py``'s gossip batch case: the port's
    ``submit_share_batch`` through ``ValidationBackend(device="cpu",
    min_batch=1)`` (the plain B2 version, one dispatch) links what the
    reference's per-share path links, and a forged member rejects."""
    from otedama_tpu_torch.runtime.validate import ValidationBackend

    results = []
    for m in (REF, PORT):
        pool = m.pool.P2PPool(params=m.sc.ChainParams(min_difficulty=TEST_D))
        if m is PORT:
            pool.validator = ValidationBackend(min_batch=1, tripwire_rate=0.0,
                                               device="cpu")
        shares = mine_chain(m, 4, ts_ms=TS_MS)
        statuses = await pool.submit_share_batch(shares)
        bad = m.sc.mine_share(shares[-1].share_id, "evil", "jobX", TEST_D,
                              ts_ms=TS_MS)
        raw = bytearray(bad.header)
        raw[76] ^= 0xFF
        forged = m.sc.Share.from_payload({**bad.to_payload(),
                                          "header": bytes(raw).hex()})
        with pytest.raises(m.sc.ShareInvalid) as e:
            await pool.submit_share_batch([forged, bad])
        results.append((statuses, pool.chain.tip, pool.chain.height,
                        e.value.reason, pool.weights()))
        if m is PORT:
            snap = pool.validator.snapshot()
            assert snap["device_batches"] == 2 and snap["rejects"] == 1
            assert pool.stats["verify_failures"] == 0
    assert results[0] == results[1]
    assert results[1][0] == ["accepted"] * 4 and results[1][3] == "pow"


@pytest.mark.asyncio
async def test_a_raising_validator_is_a_counted_fallback():
    """ROADMAP Queue C 29: when ``verify_batch`` raises, the reference
    re-verifies the batch on the host; the port checks nothing there.
    Each share the validator was given gets the error as its verdict,
    counts in ``verify_failures``, and is neither linked nor relayed."""

    class Raising:
        calls = 0

        async def verify_batch(self, checks):
            Raising.calls += 1
            raise RuntimeError("verify kernel fault")

    results = []
    for m in (REF, PORT):
        a, b, c = (m.pool.P2PPool(_pin(m, 20 + i), params(m))
                   for i in range(3))
        b.validator = Raising()
        net = m.memnet.MemoryNetwork()
        net.link(a.node, b.node)
        net.link(b.node, c.node)
        try:
            shares = mine_chain(m, 5, ts_ms=TS_MS)
            forged = bytearray(shares[2].header)
            forged[76] ^= 0xFF
            batch = shares[:2] + [m.sc.Share.from_payload(
                {**shares[2].to_payload(), "header": bytes(forged).hex()})]
            await a.node.broadcast(m.messages.P2PMessage(
                m.messages.MessageType.SHARE_BATCH,
                {"shares": [s.to_payload() for s in batch]}))
            if m is REF:
                await _wait_for(lambda: c.stats["shares_accepted"] == 2)
            else:
                await _wait_for(lambda: b.stats["verify_failures"] == 3)
                for _ in range(20):      # room for a relay that must not come
                    await asyncio.sleep(0)
            results.append((b.chain.height, dict(b.rejects),
                            b.stats["shares_accepted"],
                            b.stats["verify_failures"],
                            c.chain.height, c.stats["shares_accepted"]))
        finally:
            await net.close()
    assert Raising.calls == 2
    assert results[0] == (2, {"pow": 1}, 2, 0, 2, 2)
    assert results[1] == (0, {}, 0, 3, 0, 0)


def test_port_refuses_the_chain_store_by_name(tmp_path):
    """The port once refused a chain store by name; it now carries one
    (``p2p/chainstore.py``). A ``ShareChain`` and a ``P2PPool`` take a
    ``ChainStore``, and ``load()`` refuses as the reference's does: with
    no store attached, and on a chain that is not empty."""
    from otedama_tpu_torch.p2p.chainstore import ChainStore, ChainStoreConfig

    for m in (REF, PORT):
        with pytest.raises(ValueError, match="no chain store attached"):
            m.sc.ShareChain().load()
    store = ChainStore(ChainStoreConfig(path=str(tmp_path / "chain")))
    pool = PORT.pool.P2PPool(_pin(PORT, 12), params(PORT), store=store)
    assert pool.chain.store is store
    assert pool.chain.load()["source"] == "empty"
    for share in mine_chain(PORT, 3, "w", ts_ms=TS_MS):
        assert pool.chain.connect(share) == "accepted"
    with pytest.raises(RuntimeError, match="empty chain"):
        pool.chain.load()
    store.close()


def test_cli_p2p_mine_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    from otedama_tpu_torch import cli

    for key, value in (("STRATUM_PORT", "0"), ("STRATUM_HOST", "127.0.0.1"),
                       ("POOL_DATABASE", ":memory:"), ("P2P_PORT", "0"),
                       ("P2P_HOST", "127.0.0.1")):
        monkeypatch.setenv(f"OTEDAMA_{key}", value)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["p2p", "--mine"])
    args = cli.build_parser().parse_args(["p2p"])
    assert args.fn is cli.cmd_p2p and not args.mine
