"""Port parity, the stratum V1 pool and client: the reference cases of
``tests/test_stratum.py``, the V1 cases of ``tests/test_stratum_hotpath.py``
(for the algorithms the port carries), ``tests/test_pool.py``'s failover
case and five cases of ``tests/test_chaos.py`` (each under its package's
own fault injector), run through both packages with the same inputs and
assertions (parametrised ``jax`` / ``torch``). The loopback case mines on
the reference's ``PythonBackend`` and on the port's
``TorchBackend(device="cpu")``.

Then the packages against each other on numpy-seeded inputs: the same
notify params give equal ``Job`` fields, the same submits the same
verdicts and error codes, ``ShareAssembler.header`` the same bytes, and
``VardiffManager`` the same retarget sequence for the same share times.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import importlib
import os
import random
import sqlite3
import struct
import time
import types

import numpy as np
import pytest


def _package(root: str, loop_backend):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        sp=mod("stratum.protocol"), server=mod("stratum.server"),
        client=mod("stratum.client"), jobs=mod("engine.jobs"),
        tgt=mod("kernels.target"), types=mod("engine.types"),
        engine=mod("engine.engine"), failover=mod("pool.failover"),
        faults=mod("utils.faults"), database=mod("db.database"),
        manager=mod("pool.manager"), blockchain=mod("pool.blockchain"),
        sha=mod("utils.sha256_host"), pow=mod("utils.pow_host"),
        vardiff=mod("engine.vardiff"), search=mod("runtime.search"),
        loop_backend=loop_backend,
    )


REF = _package("otedama_tpu", lambda search: search.PythonBackend())
PORT = _package("otedama_tpu_torch",
                lambda search: search.TorchBackend(device="cpu"))
PACKAGES = pytest.mark.parametrize("m", [REF, PORT], ids=["jax", "torch"])

EASY = 1e-7  # ~2.3e-3 hit probability per hash


def make_job(m, job_id: str = "j1", nbits: int = 0x1D00FFFF):
    return m.types.Job(
        job_id=job_id,
        prev_hash=bytes(range(32)),
        coinb1=bytes.fromhex("01000000010000000000000000"),
        coinb2=bytes.fromhex("ffffffff0100f2052a01000000"),
        merkle_branch=[bytes([i] * 32) for i in (7, 9)],
        version=0x20000000,
        nbits=nbits,
        ntime=int(time.time()),
        clean=True,
    )


def mine_share(m, job, extranonce1: bytes, difficulty: float,
               en2: bytes) -> int:
    """Brute-force a nonce meeting ``difficulty`` for this en2 space."""
    target = m.tgt.difficulty_to_target(difficulty)
    job = dataclasses.replace(job, extranonce1=extranonce1)
    prefix = m.jobs.build_header_prefix(job, en2)
    for nonce in range(1 << 22):
        if m.tgt.hash_meets_target(
                m.sha.sha256d(prefix + struct.pack(">I", nonce)), target):
            return nonce
    raise AssertionError("no share found")


async def _raw_caller(m, port: int, timeout: float = 5.0):
    """A raw-wire miner: ``call`` sends one request and returns its
    response, collecting notifies on the way."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    notifies = []

    async def call(msg_id, method, params, timeout=timeout):
        writer.write(m.sp.encode_line(
            m.sp.Message(id=msg_id, method=method, params=params)))
        await writer.drain()
        while True:
            msg = m.sp.decode_line(
                await asyncio.wait_for(reader.readline(), timeout))
            if msg.method == "mining.notify":
                notifies.append(msg.params)
            if msg.is_response and msg.id == msg_id:
                return msg

    return reader, writer, call, notifies


# -- tests/test_stratum.py -------------------------------------------------------

@PACKAGES
def test_message_roundtrip(m):
    sp = m.sp
    for msg in [
        sp.Message(id=1, method="mining.subscribe", params=["agent"]),
        sp.Message(id=None, method="mining.notify", params=[1, 2, 3]),
        sp.Message(id=7, result=True, error=None),
        sp.Message(id=8, result=None, error=[21, "stale", None]),
    ]:
        back = sp.decode_line(sp.encode_line(msg))
        assert back.id == msg.id
        assert back.method == msg.method
        if msg.method:
            assert back.params == msg.params
        else:
            assert back.result == msg.result
            assert back.error == msg.error


@PACKAGES
def test_notify_roundtrip(m):
    job = make_job(m)
    params = m.sp.notify_params(job)
    back = m.sp.job_from_notify(
        params, extranonce1=b"\x00\x00\x00\x01", extranonce2_size=4,
        share_difficulty=2.0,
    )
    for field in ("job_id", "prev_hash", "coinb1", "coinb2", "merkle_branch",
                  "version", "nbits", "ntime", "clean"):
        assert getattr(back, field) == getattr(job, field), field
    assert back.share_target == m.tgt.difficulty_to_target(2.0)


@PACKAGES
def test_submit_params_parse(m):
    params = ["wallet.worker", "j1", "0000002a", "68000000", "deadbeef"]
    sub = m.sp.ShareSubmission.from_params(params)
    assert sub.worker_user == "wallet.worker"
    assert sub.extranonce2 == bytes.fromhex("0000002a")
    assert sub.ntime == 0x68000000
    assert sub.nonce_word == 0xDEADBEEF
    assert sub.nonce_bytes == bytes.fromhex("deadbeef")
    with pytest.raises(m.sp.StratumError):
        m.sp.ShareSubmission.from_params(["w", "j"])


@PACKAGES
@pytest.mark.asyncio
async def test_server_validates_and_rejects(m):
    shares: list = []

    async def on_share(s):
        shares.append(s)

    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY),
        on_share=on_share)
    await server.start()
    try:
        job = make_job(m)
        server.set_job(job)
        reader, writer, call, _ = await _raw_caller(m, server.port)
        sub = await call(1, "mining.subscribe", ["test-agent"])
        extranonce1 = bytes.fromhex(sub.result[1])
        auth = await call(2, "mining.authorize", ["w.x", "x"])
        assert auth.result is True

        en2 = b"\x00" * 4
        nonce = mine_share(m, job, extranonce1, EASY, en2)
        submit = ["w.x", job.job_id, en2.hex(), f"{job.ntime:08x}",
                  f"{nonce:08x}"]
        ok = await call(3, "mining.submit", submit)
        assert ok.result is True, ok.error
        assert len(shares) == 1
        assert shares[0].worker_user == "w.x"

        dup = await call(4, "mining.submit", submit)
        assert dup.result is None and dup.error[0] == m.sp.ERR_DUPLICATE

        bad = await call(5, "mining.submit",
                         ["w.x", "nope"] + submit[2:])
        assert bad.error is not None

        low = await call(6, "mining.submit", ["w.x", job.job_id, "00000001",
                                              f"{job.ntime:08x}", "00000000"])
        # this could meet the easy target by chance; either outcome holds
        assert low.result is True or low.error is not None
        writer.close()
    finally:
        await server.stop()


@PACKAGES
@pytest.mark.asyncio
async def test_mining_loopback_end_to_end(m):
    """Server broadcasts a job; the engine mines it through the stratum
    client; the server validates and accepts the submitted shares."""
    accepted: list = []

    async def on_share(s):
        accepted.append(s)

    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY),
        on_share=on_share)
    await server.start()
    engine = m.engine.MiningEngine(
        backends={"loop0": m.loop_backend(m.search)},
        config=m.engine.EngineConfig(batch_size=2048, worker_name="w"),
    )
    client = m.client.StratumClient(
        m.client.ClientConfig(host="127.0.0.1", port=server.port,
                              username="wallet.rig"),
        on_job=engine.set_job,
    )
    results = []

    async def submit(share):
        results.append(await client.submit(share))

    engine.on_share = submit
    try:
        await asyncio.wait_for(client.start(), 5)
        server.set_job(make_job(m, "loop1"))
        await engine.start()

        async def until_accept():
            while not accepted:
                await asyncio.sleep(0.05)

        await asyncio.wait_for(until_accept(), 30)
    finally:
        await engine.stop()
        await client.stop()
        await server.stop()

    assert accepted, "no share accepted"
    assert any(r.accepted for r in results), "client saw no accept verdict"
    lats = sorted(r.latency for r in results if r.accepted)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    assert p50 < 0.05, f"p50 {p50 * 1e3:.1f}ms exceeds the 50ms frame"
    assert p99 < 1.0, f"p99 {p99 * 1e3:.1f}ms absurd for loopback"
    assert client.latency_count == len(results)
    assert client.latency_buckets[5.0] == len(results)
    assert engine.stats.shares_found >= 1
    assert server.stats["shares_valid"] >= 1


# -- tests/test_stratum_hotpath.py (V1) -------------------------------------------

HOST_ALGORITHMS = ("sha256d", "sha256", "scrypt")   # the port's pow_host set


def _random_job(m, rng: random.Random, algorithm: str):
    return m.types.Job(
        job_id=f"r{rng.randrange(1 << 30):x}",
        prev_hash=rng.randbytes(32),
        coinb1=rng.randbytes(rng.randrange(0, 150)),
        coinb2=rng.randbytes(rng.randrange(0, 150)),
        merkle_branch=[rng.randbytes(32) for _ in range(rng.randrange(0, 6))],
        version=rng.getrandbits(32),
        nbits=rng.getrandbits(32),
        ntime=rng.getrandbits(32),
        algorithm=algorithm,
        extranonce1=rng.randbytes(rng.randrange(0, 9)),
        extranonce2_size=rng.choice([2, 4, 8]),
        block_number=10,
    )


@PACKAGES
def test_sha256_midstate_matches_one_shot(m):
    rng = random.Random(11)
    for _ in range(50):
        prefix = rng.randbytes(rng.randrange(0, 200))
        suffix = rng.randbytes(rng.randrange(0, 200))
        mid = m.sha.Sha256Midstate(prefix)
        assert mid.digest_suffix(suffix) == hashlib.sha256(
            prefix + suffix).digest()
        assert mid.sha256d_suffix(suffix) == m.sha.sha256d(prefix + suffix)


@PACKAGES
def test_share_assembler_bit_identical_all_host_algorithms(m):
    rng = random.Random(1202)
    for algorithm in HOST_ALGORITHMS:
        for _ in range(8):
            job = _random_job(m, rng, algorithm)
            asm = m.jobs.ShareAssembler(job)
            for _ in range(4):
                en2 = rng.randbytes(job.extranonce2_size)
                ntime = rng.getrandbits(32)
                nonce = rng.getrandbits(32)
                want = m.jobs.header_from_share(job, en2, ntime, nonce)
                assert asm.header(en2, ntime, nonce) == want, algorithm
    for algorithm in HOST_ALGORITHMS:
        job = _random_job(m, rng, algorithm)
        asm = m.jobs.ShareAssembler(job)
        en2 = rng.randbytes(job.extranonce2_size)
        h1 = m.jobs.header_from_share(job, en2, job.ntime, 7)
        h2 = asm.header(en2, job.ntime, 7)
        assert m.pow.pow_digest(h1, algorithm) == m.pow.pow_digest(h2, algorithm)


@PACKAGES
def test_share_assembler_session_overrides(m):
    rng = random.Random(3)
    job = _random_job(m, rng, "sha256d")
    en1 = b"\x00\x00\x00\x2a"
    asm = m.jobs.ShareAssembler(job, en1, 4)
    jobx = dataclasses.replace(job, extranonce1=en1, extranonce2_size=4)
    en2 = b"\x01\x02\x03\x04"
    assert asm.header(en2, job.ntime, 99) == m.jobs.header_from_share(
        jobx, en2, job.ntime, 99)
    with pytest.raises(ValueError):
        asm.header(b"\x01", job.ntime, 99)


def _hot_job(m, job_id: str):
    return m.types.Job(
        job_id=job_id, prev_hash=bytes(32),
        coinb1=bytes.fromhex("01000000010000000000000000"),
        coinb2=bytes.fromhex("ffffffff0100f2052a01000000"),
        merkle_branch=[bytes(range(32))],
        version=0x20000000, nbits=0x1D00FFFF, ntime=int(time.time()),
        clean=True, algorithm="sha256d",
    )


@PACKAGES
@pytest.mark.asyncio
async def test_notify_bytes_cache_invalidated_on_job_switch(m):
    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY))
    await server.start()
    try:
        server.set_job(_hot_job(m, "jobA"))
        r1, w1, call1, notifies1 = await _raw_caller(m, server.port, 10)
        await call1(1, "mining.subscribe", ["a"])
        await call1(99, "mining.ping", [])
        assert notifies1 and notifies1[-1][0] == "jobA"

        server.set_job(_hot_job(m, "jobB"))
        await call1(100, "mining.ping", [])
        assert notifies1[-1][0] == "jobB", notifies1

        r2, w2, call2, notifies2 = await _raw_caller(m, server.port, 10)
        await call2(1, "mining.subscribe", ["b"])
        await call2(99, "mining.ping", [])
        assert [p[0] for p in notifies2] == ["jobB"]
        assert notifies2[-1][8] is True

        cache = server.job_cache["jobB"]
        fresh = m.sp.encode_line(m.sp.Message(
            method="mining.notify",
            params=m.sp.notify_params(server.jobs["jobB"], True)))
        assert cache.notify_clean_line == fresh
        assert cache.network_target == m.tgt.bits_to_target(0x1D00FFFF)
        w1.close()
        w2.close()
    finally:
        await server.stop()


def _hot_mine(m, job, en1: bytes, difficulty: float, en2: bytes):
    return en2, mine_share(m, job, en1, difficulty, en2)


@PACKAGES
@pytest.mark.asyncio
async def test_difficulty_retarget_invalidates_target_cache(m):
    accepted = []

    async def on_share(s):
        accepted.append(s)

    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY),
        on_share=on_share)
    await server.start()
    tgt = m.tgt
    try:
        job = _hot_job(m, "jobT")
        server.set_job(job)
        r, w, call, _n = await _raw_caller(m, server.port, 10)
        sub = await call(1, "mining.subscribe", ["t"])
        en1 = bytes.fromhex(sub.result[1])
        await call(2, "mining.authorize", ["w.t", "x"])

        session = next(iter(server.sessions.values()))
        assert session.target == tgt.difficulty_to_target(EASY)
        assert session.prev_target is None

        en2, nonce = _hot_mine(m, job, en1, EASY, b"\x00\x00\x00\x01")
        ok = await call(3, "mining.submit",
                        ["w.t", "jobT", en2.hex(), f"{job.ntime:08x}",
                         f"{nonce:08x}"])
        assert ok.result is True

        hard = EASY * 10000
        server._send_difficulty(session, hard)
        assert session.difficulty == hard
        assert session.target == tgt.difficulty_to_target(hard)
        assert session.prev_target == tgt.difficulty_to_target(EASY)

        # a share meeting only the OLD target is credited at the old
        # difficulty (the retarget window)
        for attempt in range(2, 64):
            en2b, nonceb = _hot_mine(m, job, en1, EASY,
                                     struct.pack(">I", attempt))
            h = m.jobs.header_from_share(
                dataclasses.replace(job, extranonce1=en1), en2b, job.ntime,
                nonceb)
            if not tgt.hash_meets_target(m.sha.sha256d(h), session.target):
                break
        else:
            raise AssertionError("every easy share met the hard target")
        ok2 = await call(4, "mining.submit",
                         ["w.t", "jobT", en2b.hex(), f"{job.ntime:08x}",
                          f"{nonceb:08x}"])
        assert ok2.result is True
        assert accepted[-1].difficulty == EASY
        w.close()
    finally:
        await server.stop()


@PACKAGES
@pytest.mark.asyncio
async def test_seen_and_assembler_pruned_with_expired_jobs(m):
    server = m.server.StratumServer(m.server.ServerConfig(
        port=0, initial_difficulty=EASY, job_max_age=5.0))
    await server.start()
    try:
        jobA = _hot_job(m, "oldjob")
        server.set_job(jobA)
        r, w, call, _n = await _raw_caller(m, server.port, 10)
        sub = await call(1, "mining.subscribe", ["p"])
        en1 = bytes.fromhex(sub.result[1])
        await call(2, "mining.authorize", ["w.p", "x"])
        en2, nonce = _hot_mine(m, jobA, en1, EASY, b"\x51\x00\x00\x00")
        ok = await call(3, "mining.submit",
                        ["w.p", "oldjob", en2.hex(), f"{jobA.ntime:08x}",
                         f"{nonce:08x}"])
        assert ok.result is True
        session = next(iter(server.sessions.values()))
        assert any(k[0] == "oldjob" for k in session.seen)
        assert "oldjob" in session.assemblers

        server.jobs["oldjob"] = dataclasses.replace(
            jobA, received_at=time.time() - 11.0)
        server.set_job(_hot_job(m, "newjob"))
        assert "oldjob" not in server.jobs
        assert "oldjob" not in server.job_cache
        assert not any(k[0] == "oldjob" for k in session.seen)
        assert "oldjob" not in session.assemblers
        w.close()
    finally:
        await server.stop()


@PACKAGES
@pytest.mark.asyncio
async def test_backlog_disconnect_and_latency_histogram(m):
    """A session that stops reading is cut once its write buffer passes
    the bound; accepted submits land in the share-accept histogram that
    snapshot() surfaces. (The reference case's /metrics rendering belongs
    to its API tier, which the port does not carry yet.)"""
    server = m.server.StratumServer(m.server.ServerConfig(
        port=0, initial_difficulty=EASY, max_write_backlog=8 * 1024))
    await server.start()
    try:
        job = _hot_job(m, "jobL")
        server.set_job(job)
        r, w, call, _n = await _raw_caller(m, server.port, 10)
        sub = await call(1, "mining.subscribe", ["l"])
        en1 = bytes.fromhex(sub.result[1])
        await call(2, "mining.authorize", ["w.l", "x"])
        en2, nonce = _hot_mine(m, job, en1, EASY, b"\x4c\x00\x00\x00")
        ok = await call(3, "mining.submit",
                        ["w.l", "jobL", en2.hex(), f"{job.ntime:08x}",
                         f"{nonce:08x}"])
        assert ok.result is True

        assert server.latency.count == 1
        snap = server.snapshot()
        assert snap["accept_latency"]["count"] == 1
        assert snap["accept_latency"]["p99_ms"] > 0
        # the buckets /metrics exports: cumulative, the 50 ms one included
        cum = server.latency.cumulative()
        assert 0.05 in cum and cum[max(cum)] == 1

        for i in range(20000):
            server.set_job(_hot_job(m, f"flood{i}"))
            if server.stats["backlog_disconnects"]:
                break
        assert server.stats["backlog_disconnects"] >= 1
        await asyncio.sleep(0.2)
        assert not server.sessions
    finally:
        await server.stop()


# -- tests/test_pool.py ----------------------------------------------------------

@PACKAGES
@pytest.mark.asyncio
async def test_failover_scoring_and_selection(m):
    f = m.failover
    good = f.UpstreamPool("good", "127.0.0.1", 1, priority=1)
    bad = f.UpstreamPool("bad", "127.0.0.1", 2, priority=0)
    fm = f.FailoverManager([good, bad], f.FailoverStrategy.PRIORITY,
                           failure_threshold=1)
    server = await asyncio.start_server(lambda r, w: w.close(), "127.0.0.1", 0)
    good.port = server.sockets[0].getsockname()[1]
    bad.port = good.port + 1 if good.port < 65000 else good.port - 1
    await fm.check_all()
    server.close()
    await server.wait_closed()

    assert good.reachable
    if not bad.reachable:
        assert fm.select() is good
    fm.record_share_result(good, accepted=False)
    fm.record_share_result(good, accepted=True)
    assert good.reject_rate == 0.5
    assert 0.0 < good.health_score() <= 1.0
    fm2 = f.FailoverManager([good, bad], f.FailoverStrategy.PERFORMANCE)
    if not bad.reachable:
        assert fm2.select() is good


# -- tests/test_chaos.py ---------------------------------------------------------

@PACKAGES
@pytest.mark.asyncio
async def test_chaos_failover_under_injected_unreachability_and_latency(m):
    f, faults = m.failover, m.faults

    # the stub listeners close what they accept: since Python 3.12.1
    # ``Server.wait_closed`` waits for every accepted connection, and the
    # reference case's handlers, which leave them open, hang its cleanup
    async def _noop(reader, writer):
        writer.close()

    srv_a = await asyncio.start_server(_noop, "127.0.0.1", 0)
    srv_b = await asyncio.start_server(_noop, "127.0.0.1", 0)
    port_a = srv_a.sockets[0].getsockname()[1]
    port_b = srv_b.sockets[0].getsockname()[1]
    try:
        def pools():
            return [
                f.UpstreamPool("primary", "127.0.0.1", port_a, priority=0),
                f.UpstreamPool("backup", "127.0.0.1", port_b, priority=1),
            ]

        fm = f.FailoverManager(pools(), f.FailoverStrategy.PRIORITY,
                               failure_threshold=2)
        inj = faults.FaultInjector(2024).error(
            "pool.failover.check:primary", exc=OSError, max_fires=2)
        with faults.active(inj):
            assert fm.select().name == "primary"
            checks_to_converge = 0
            while fm.select().name != "backup":
                await fm.check_all()
                checks_to_converge += 1
                assert checks_to_converge <= 2, "no bounded convergence"
            await fm.check_all()
            assert fm.select().name == "primary"
        assert inj.snapshot()["points"][
            "pool.failover.check:primary"]["faults"] == 2

        fm2 = f.FailoverManager(pools(), f.FailoverStrategy.PERFORMANCE)
        inj2 = faults.FaultInjector(99).delay(
            "pool.failover.check:primary", seconds=0.15)
        with faults.active(inj2):
            await fm2.check_all()
            await fm2.check_all()
        a, b = fm2.pools
        assert a.latency > b.latency
        assert fm2.select().name == "backup"
        snap = fm2.snapshot()
        assert {p["name"] for p in snap} == {"primary", "backup"}
        assert next(p for p in snap if p["name"] == "primary")["score"] < \
            next(p for p in snap if p["name"] == "backup")["score"]

        for strategy in (f.FailoverStrategy.ROUND_ROBIN,
                         f.FailoverStrategy.LOAD_BALANCED):
            fm3 = f.FailoverManager(pools(), strategy, failure_threshold=1)
            inj3 = faults.FaultInjector(7).error(
                "pool.failover.check:primary", exc=OSError)
            with faults.active(inj3):
                await fm3.check_all()
                assert all(fm3.select().name == "backup" for _ in range(4))
    finally:
        srv_a.close()
        srv_b.close()
        await srv_a.wait_closed()
        await srv_b.wait_closed()


@PACKAGES
@pytest.mark.asyncio
async def test_chaos_upstream_flap_client_reconnects_and_failover_converges(m):
    f, faults = m.failover, m.faults
    accepted_srv = []

    async def on_share(s):
        accepted_srv.append(s)

    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY),
        on_share=on_share)
    await server.start()
    backup_srv = await asyncio.start_server(lambda r, w: w.close(),
                                            "127.0.0.1", 0)
    backup_port = backup_srv.sockets[0].getsockname()[1]
    job = make_job(m, "flap1")
    server.set_job(job)

    jobs_seen: list = []
    client = m.client.StratumClient(
        m.client.ClientConfig(host="127.0.0.1", port=server.port,
                              username="w.flap", response_timeout=2.0,
                              reconnect_initial=0.05, reconnect_max=0.1),
        on_job=jobs_seen.append,
    )
    fm = f.FailoverManager(
        [f.UpstreamPool("primary", "127.0.0.1", server.port, priority=0),
         f.UpstreamPool("backup", "127.0.0.1", backup_port, priority=1)],
        f.FailoverStrategy.PRIORITY, failure_threshold=2,
    )
    try:
        await asyncio.wait_for(client.start(), 5)
        for _ in range(100):
            if jobs_seen:
                break
            await asyncio.sleep(0.02)
        assert jobs_seen, "no job before the flap"

        async def submit_one(tag: bytes) -> bool:
            j = dataclasses.replace(client.current_job or jobs_seen[-1])
            nonce = mine_share(m, j, client.extranonce1, EASY, tag)
            res = await client.submit(m.types.Share(
                job_id=j.job_id, worker="w.flap", extranonce2=tag,
                ntime=j.ntime, nonce_word=nonce, digest=b"\x00" * 32,
                difficulty=EASY))
            return res.accepted

        assert await submit_one(b"\x00\x00\x00\x01")

        flap = (faults.FaultInjector(4242)
                .error(f"stratum.client.read:127.0.0.1:{server.port}",
                       exc=ConnectionError, window=(0.0, 0.6))
                .error("pool.failover.check:primary", exc=OSError,
                       window=(0.0, 0.6)))
        with faults.active(flap):
            t0 = time.monotonic()
            while fm.select().name != "backup":
                await fm.check_all()
                assert time.monotonic() - t0 < 3.0, \
                    "failover did not converge during the flap"
            wave = 0
            while time.monotonic() - flap.armed_at < 0.8:
                wave += 1
                server.set_job(make_job(m, f"flapwave{wave}"))
                await asyncio.sleep(0.05)
        assert client.stats["reconnects"] >= 1, \
            "injected read faults never tripped the reconnect loop"

        await fm.check_all()
        assert fm.select().name == "primary"
        await asyncio.wait_for(client.connected.wait(), 5)
        t0 = time.monotonic()
        while True:
            if await submit_one(os.urandom(2) + b"\x00\x07"):
                break
            assert time.monotonic() - t0 < 5.0, "no accept after recovery"
        assert client.stats["shares_accepted"] >= 2
        assert len(accepted_srv) == client.stats["shares_accepted"]
    finally:
        await client.stop()
        await server.stop()
        backup_srv.close()
        await backup_srv.wait_closed()


@PACKAGES
@pytest.mark.asyncio
async def test_chaos_mid_submit_drops_never_lose_or_double_count(m):
    faults, sp = m.faults, m.sp
    db = m.database.Database(":memory:")
    pool = m.manager.PoolManager(db, m.blockchain.MockChainClient())
    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY),
        on_share=pool.on_share)
    await server.start()
    try:
        job = make_job(m, "drop1")
        server.set_job(job)
        reader, writer, call, _ = await _raw_caller(m, server.port, 0.4)
        sub = await call(1, "mining.subscribe", ["chaos-drop"], timeout=5)
        en1 = bytes.fromhex(sub.result[1])
        await call(2, "mining.authorize", ["w.drop", "x"], timeout=5)

        inj = faults.FaultInjector(777).drop("stratum.server.write",
                                             every_nth=3)
        seen_accepts = 0
        lost_verdicts = 0
        submitted = []
        with faults.active(inj):
            for i in range(9):
                en2 = struct.pack(">HH", 0xD0, i)
                nonce = mine_share(m, job, en1, EASY, en2)
                params = ["w.drop", job.job_id, en2.hex(),
                          f"{job.ntime:08x}", f"{nonce:08x}"]
                try:
                    msg = await call(100 + i, "mining.submit", params)
                except asyncio.TimeoutError:
                    lost_verdicts += 1
                    submitted.append(params)
                    continue
                assert msg.result is True, msg.error
                seen_accepts += 1
        assert lost_verdicts >= 2, "the drop schedule never fired"

        dup = await call(500, "mining.submit", submitted[0], timeout=5)
        assert dup.result is not True
        assert dup.error[0] == sp.ERR_DUPLICATE

        rows = db.query("SELECT COUNT(*) AS c FROM shares")[0]["c"]
        assert rows == server.stats["shares_valid"] == 9
        assert seen_accepts <= rows
        assert server.stats["shares_invalid"] == 1
        writer.close()
    finally:
        await server.stop()
        db.close()


@PACKAGES
@pytest.mark.asyncio
async def test_chaos_db_write_faults_keep_share_accounting_exact(m):
    faults = m.faults
    db = m.database.Database(":memory:")
    pool = m.manager.PoolManager(db, m.blockchain.MockChainClient())
    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY),
        on_share=pool.on_share)
    await server.start()
    try:
        job = make_job(m, "dbf1")
        server.set_job(job)
        reader, writer, call, _ = await _raw_caller(m, server.port)
        sub = await call(1, "mining.subscribe", ["chaos-db"])
        en1 = bytes.fromhex(sub.result[1])
        await call(2, "mining.authorize", ["w.db", "x"])

        inj = faults.FaultInjector(606).error(
            "db.execute", exc=sqlite3.OperationalError,
            every_nth=5, max_fires=3)
        accepts = 0
        accounting_rejects = 0
        rejected_params: list[list] = []
        with faults.active(inj):
            for i in range(10):
                en2 = struct.pack(">HH", 0xDB, i)
                nonce = mine_share(m, job, en1, EASY, en2)
                params = ["w.db", job.job_id, en2.hex(),
                          f"{job.ntime:08x}", f"{nonce:08x}"]
                msg = await call(200 + i, "mining.submit", params)
                if msg.result is True:
                    accepts += 1
                else:
                    assert "accounting" in msg.error[1]
                    accounting_rejects += 1
                    rejected_params.append(params)
        assert accounting_rejects >= 1, "db fault schedule never fired"
        assert server.stats["share_hook_failures"] == accounting_rejects

        rows = db.query("SELECT COUNT(*) AS c FROM shares")[0]["c"]
        assert rows == accepts == server.stats["shares_valid"]
        w = db.query_one(
            "SELECT shares_valid FROM workers WHERE name = ?", ("w.db",))
        assert w is not None and w["shares_valid"] == rows

        en2 = b"\xAA\x00\x00\x01"
        nonce = mine_share(m, job, en1, EASY, en2)
        msg = await call(900, "mining.submit",
                         ["w.db", job.job_id, en2.hex(),
                          f"{job.ntime:08x}", f"{nonce:08x}"])
        assert msg.result is True
        assert db.query("SELECT COUNT(*) AS c FROM shares")[0]["c"] == rows + 1

        retry = await call(901, "mining.submit", rejected_params[0])
        assert retry.result is True, retry.error
        assert db.query("SELECT COUNT(*) AS c FROM shares")[0]["c"] == rows + 2
        writer.close()
    finally:
        await server.stop()
        db.close()


@PACKAGES
@pytest.mark.asyncio
async def test_chaos_block_candidate_survives_accounting_outage(m):
    blocks = []

    async def failing_share_hook(s):
        raise sqlite3.OperationalError("accounting down")

    async def on_block(header, job, share):
        blocks.append(header)

    server = m.server.StratumServer(
        m.server.ServerConfig(port=0, initial_difficulty=EASY),
        on_share=failing_share_hook, on_block=on_block,
    )
    await server.start()
    try:
        job = make_job(m, "blkout", nbits=0x207FFFFF)
        server.set_job(job)
        reader, writer, call, _ = await _raw_caller(m, server.port)
        sub = await call(1, "mining.subscribe", ["chaos-blk"])
        en1 = bytes.fromhex(sub.result[1])
        await call(2, "mining.authorize", ["w.blk", "x"])
        en2 = b"\x00\x00\x00\x2A"
        nonce = mine_share(m, job, en1, EASY, en2)
        msg = await call(3, "mining.submit",
                         ["w.blk", job.job_id, en2.hex(),
                          f"{job.ntime:08x}", f"{nonce:08x}"])
        assert msg.result is not True and "accounting" in msg.error[1]
        assert blocks, "block candidate lost to the accounting outage"
        assert server.stats["blocks_found"] == 1
        assert server.stats["share_hook_failures"] == 1
        writer.close()
    finally:
        await server.stop()


# -- the packages against each other ---------------------------------------------

def _job_fields(job) -> dict:
    d = dataclasses.asdict(job)
    d.pop("received_at")
    return d


def _seeded_jobs(rng: np.random.Generator, n: int):
    """``n`` job field sets from numpy: random header fields, coinbase
    halves, branches and extranonce sizes."""
    out = []
    for i in range(n):
        def b(k):
            return rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes()
        out.append(dict(
            job_id=f"s{i:x}", prev_hash=b(32),
            coinb1=b(rng.integers(0, 120)), coinb2=b(rng.integers(0, 120)),
            merkle_branch=[b(32) for _ in range(int(rng.integers(0, 5)))],
            version=int(rng.integers(1 << 32)), nbits=int(rng.integers(1 << 32)),
            ntime=int(rng.integers(1 << 32)), clean=bool(rng.integers(2)),
            extranonce1=b(rng.integers(0, 9)),
            extranonce2_size=int(rng.choice([2, 4, 8])),
        ))
    return out


def test_notify_params_give_equal_jobs_across_packages():
    rng = np.random.default_rng(20261017)
    for fields in _seeded_jobs(rng, 32):
        params = REF.sp.notify_params(REF.types.Job(**fields))
        assert PORT.sp.notify_params(PORT.types.Job(**fields)) == params
        kw = dict(extranonce1=fields["extranonce1"],
                  extranonce2_size=fields["extranonce2_size"],
                  share_difficulty=float(rng.uniform(1e-6, 1e3)),
                  algorithm="sha256d")
        want = _job_fields(REF.sp.job_from_notify(params, **kw))
        got = _job_fields(PORT.sp.job_from_notify(params, **kw))
        assert got == want
        assert PORT.jobs.decode_prevhash(params[1]) == fields["prev_hash"]
        assert PORT.jobs.encode_prevhash(fields["prev_hash"]) == params[1]


def test_share_assembler_headers_equal_across_packages():
    rng = np.random.default_rng(7)
    for fields in _seeded_jobs(rng, 24):
        ref = REF.jobs.ShareAssembler(REF.types.Job(**fields))
        port = PORT.jobs.ShareAssembler(PORT.types.Job(**fields))
        for _ in range(4):
            en2 = rng.integers(0, 256, fields["extranonce2_size"],
                               dtype=np.uint8).tobytes()
            ntime, nonce = (int(x) for x in rng.integers(1 << 32, size=2))
            header = port.header(en2, ntime, nonce)
            assert header == ref.header(en2, ntime, nonce)
            assert header == PORT.jobs.header_from_share(
                PORT.types.Job(**fields), en2, ntime, nonce)


def test_vardiff_retargets_equal_across_packages():
    rng = np.random.default_rng(99)
    for trial in range(8):
        cfg = dict(target_share_seconds=float(rng.uniform(0.2, 5.0)),
                   retarget_seconds=float(rng.uniform(1.0, 10.0)),
                   window=int(rng.integers(4, 64)))
        mgrs = [pkg.vardiff.VardiffManager(pkg.vardiff.VardiffConfig(**cfg),
                                           initial_difficulty=1 / 64)
                for pkg in (REF, PORT)]
        t0 = 1_000_000.0
        for mgr in mgrs:
            mgr.difficulty("w")
            mgr._workers["w"].last_retarget = t0
        # bursts and droughts of shares, so the difficulty moves both ways
        rates = rng.choice([0.0, 0.5, 4.0, 40.0], size=40)
        now, seqs = t0, ([], [])
        for rate in rates:
            n = int(rng.poisson(rate))
            times = np.sort(rng.uniform(now, now + 1.0, size=n))
            now += 1.0
            for mgr, seq in zip(mgrs, seqs):
                for t in times:
                    mgr.record_share("w", when=float(t))
                seq.append(mgr.maybe_retarget("w", now=now))
        assert seqs[0] == seqs[1]
        assert any(x is not None for x in seqs[0]), trial


@pytest.mark.asyncio
async def test_the_same_submits_get_the_same_verdicts_across_packages():
    """One job, one script of submits — accepted, duplicate, unknown job,
    low difficulty, a short extranonce2, an ntime out of range, malformed
    params, unauthorised — against a reference and a port server: the
    same results and error codes, in order."""
    rng = np.random.default_rng(5)
    ntime = int(time.time())

    async def run(m):
        job = dataclasses.replace(make_job(m, "v1"), ntime=ntime)
        server = m.server.StratumServer(
            m.server.ServerConfig(port=0, initial_difficulty=EASY))
        await server.start()
        try:
            server.set_job(job)
            reader, writer, call, _ = await _raw_caller(m, server.port)
            verdicts = []
            early = await call(9, "mining.submit",
                               ["w.v", "v1", "00000000", f"{ntime:08x}",
                                "00000000"])
            verdicts.append((early.result, early.error and early.error[0]))
            sub = await call(1, "mining.subscribe", ["v"])
            en1 = bytes.fromhex(sub.result[1])
            await call(2, "mining.authorize", ["w.v", "x"])
            script = []
            for i in range(6):
                en2 = rng_en2[i]
                nonce = mine_share(m, job, en1, EASY, en2)
                script.append([en2.hex(), f"{ntime:08x}", f"{nonce:08x}"])
            script += [script[0],                                  # duplicate
                       ["00000000", f"{ntime:08x}", "00000000"],   # low (p~2e-3)
                       ["0000", f"{ntime:08x}", "00000000"],        # short en2
                       ["00000001", f"{ntime + 4000:08x}", "00000000"]]
            for i, (en2, nt, nonce) in enumerate(script):
                msg = await call(100 + i, "mining.submit",
                                 ["w.v", "v1", en2, nt, nonce])
                verdicts.append((msg.result, msg.error and msg.error[0]))
            for i, params in enumerate((["w.v", "nope", "00000000",
                                         f"{ntime:08x}", "00000000"],
                                        ["w.v", "v1"],
                                        ["w.v", "v1", "zz", "00", "00"])):
                msg = await call(200 + i, "mining.submit", params)
                verdicts.append((msg.result, msg.error and msg.error[0]))
            writer.close()
            return verdicts, dict(server.stats)
        finally:
            await server.stop()

    rng_en2 = [rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
               for _ in range(6)]
    ref, ref_stats = await run(REF)
    port, port_stats = await run(PORT)
    assert port == ref
    assert [v[0] for v in ref[1:7]] == [True] * 6
    assert ref[7] == (None, REF.sp.ERR_DUPLICATE)
    assert {k: port_stats[k] for k in ref_stats} == ref_stats
