"""The port's pool, stratum and P2P modes on ethash, on the CPU: they need
no module of their own (they reach ethash through ``pow_host`` and
``ValidationBackend``), and these cases hold each path to the host oracle
with a miniature epoch 0 in the port's epoch registry.

- the stratum V1 server validates an ethash share through the host
  oracle and rejects a garbage nonce (the reference's
  ``tests/test_ethash.py`` case, through the port);
- ``PoolManager.on_share_batch`` books honest ethash shares and rejects
  forged ones through ``ValidationBackend(device="cpu")``;
- a P2P pool on an ethash chain links a gossip batch of host-mined
  ethash shares through the same validator and rejects a forged one.
"""

from __future__ import annotations

import asyncio
import dataclasses
import struct

import numpy as np
import pytest

from otedama_tpu.kernels import ethash as ref
from otedama_tpu_torch.db import connect_database
from otedama_tpu_torch.engine import jobs as jobmod
from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.p2p import sharechain as sc
from otedama_tpu_torch.p2p.pool import P2PPool
from otedama_tpu_torch.pool.blockchain import MockChainClient
from otedama_tpu_torch.pool.manager import PoolManager
from otedama_tpu_torch.runtime.validate import ValidationBackend
from otedama_tpu_torch.stratum import protocol as sp
from otedama_tpu_torch.stratum.server import AcceptedShare, ServerConfig, \
    StratumServer
from otedama_tpu_torch.utils import pow_host

ROWS, PAGES = 61, 127


@pytest.fixture
def epoch0():
    """A miniature epoch 0 (the reference's native-built cache) in the
    port's registry, the registry restored after."""
    saved = dict(pow_host._ETHASH_CACHES)
    cache = ref.make_cache(ROWS * ref.HASH_BYTES, ref.seed_hash(0))
    pow_host._ETHASH_CACHES.clear()
    pow_host._ETHASH_CACHES[0] = (PAGES * ref.MIX_BYTES, cache)
    try:
        yield cache
    finally:
        pow_host._ETHASH_CACHES.clear()
        pow_host._ETHASH_CACHES.update(saved)


@pytest.mark.asyncio
async def test_v1_server_validates_ethash_shares(epoch0):
    accepted = []

    async def on_share(s):
        accepted.append(s)

    target = 1 << 255     # ~50% of hashes pass: a couple of host passes
    server = StratumServer(
        ServerConfig(port=0, initial_difficulty=tgt.target_to_difficulty(target)),
        on_share=on_share)
    await server.start()
    try:
        job = Job(job_id="eth1", prev_hash=bytes(32), coinb1=b"\x01",
                  coinb2=b"\x02", merkle_branch=[], version=0x20000000,
                  nbits=0x207FFFFF, ntime=1_700_000_000, clean=True,
                  algorithm="ethash", extranonce1=b"", extranonce2_size=4,
                  share_target=target, block_number=10)
        server.set_job(job)
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.port)

        async def call(msg_id, method, params):
            writer.write(sp.encode_line(
                sp.Message(id=msg_id, method=method, params=params)))
            await writer.drain()
            while True:
                m = sp.decode_line(await reader.readline())
                if m.is_response and m.id == msg_id:
                    return m

        sub = await call(1, "mining.subscribe", ["eth-test"])
        extranonce1 = bytes.fromhex(sub.result[1])
        await call(2, "mining.authorize", ["w.e", "x"])
        en2 = b"\x00\x00\x00\x07"
        prefix = jobmod.build_header_prefix(
            dataclasses.replace(job, extranonce1=extranonce1), en2)
        headers = [prefix + n.to_bytes(4, "big") for n in range(16)]
        digests = pow_host.pow_digests(headers, "ethash", 10)
        good = next(n for n, d in enumerate(digests)
                    if tgt.hash_meets_target(d, target))
        bad = next(n for n, d in enumerate(digests)
                   if not tgt.hash_meets_target(d, target))
        ok = await call(3, "mining.submit", ["w.e", job.job_id, en2.hex(),
                                             f"{job.ntime:08x}", f"{good:08x}"])
        assert ok.result is True, ok.error
        assert len(accepted) == 1 and accepted[0].digest == digests[good]
        assert accepted[0].algorithm == "ethash" and accepted[0].block_number == 10
        low = await call(4, "mining.submit", ["w.e", job.job_id, en2.hex(),
                                              f"{job.ntime:08x}", f"{bad:08x}"])
        assert low.result is not True
        writer.close()
    finally:
        await server.stop()


@pytest.mark.asyncio
async def test_pool_ledger_books_ethash_shares(epoch0):
    rng = np.random.default_rng(5)
    headers = [rng.integers(0, 256, 80, dtype=np.uint8).tobytes()
               for _ in range(8)]
    digests = pow_host.pow_digests(headers, "ethash", 10)
    batch, honest = [], []
    for i, (h, d) in enumerate(zip(headers, digests)):
        v = int.from_bytes(d, "little")
        ok = i not in (1, 6)
        diff = tgt.target_to_difficulty(v) * (0.5 if ok else 2.0)
        honest.append(ok)
        batch.append(AcceptedShare(
            session_id=i, worker_user=f"e.{i}", job_id="eth-ledger",
            difficulty=diff, actual_difficulty=diff, digest=d, header=h,
            extranonce2=struct.pack(">I", i), ntime=1_700_000_000,
            nonce_word=0, is_block=False, submitted_at=1_700_000_000.0,
            algorithm="ethash", block_number=10))
    pm = PoolManager(connect_database(":memory:"), MockChainClient())
    pm.validator = ValidationBackend(device="cpu", min_batch=1,
                                     tripwire_rate=0.25, seed=3)
    outcomes = await pm.on_share_batch(batch)
    assert outcomes == [("ok", "") if ok else ("err", "share failed validation")
                        for ok in honest]
    assert pm.shares.count() == 6 and pm.ledger_stats["shares_rejected"] == 2
    snap = pm.validator.snapshot()
    assert snap["device_batches"] == 1 and snap["tripwire_mismatches"] == 0


@pytest.mark.asyncio
async def test_p2p_ethash_gossip_batch_through_the_validator(epoch0):
    difficulty = 5e-10        # about one header in two meets it
    pool = P2PPool(params=sc.ChainParams(algorithm="ethash",
                                         min_difficulty=1e-10))
    pool.validator = ValidationBackend(min_batch=1, tripwire_rate=0.0,
                                       device="cpu")
    ts = 1_760_000_000_000
    shares, prev = [], sc.GENESIS
    for i in range(3):
        s = sc.mine_share(prev, f"w.{i}", f"job{i}", difficulty,
                          algorithm="ethash", ts_ms=ts)
        shares.append(s)
        prev = s.share_id
    assert await pool.submit_share_batch(shares) == ["accepted"] * 3
    assert pool.chain.tip == shares[-1].share_id and pool.chain.height == 3
    bad = sc.mine_share(prev, "evil", "jobX", difficulty, algorithm="ethash",
                        ts_ms=ts)
    # forged: the first other nonce whose digest misses the claimed target
    # (at this difficulty about one nonce in two does)
    tries = [bad.header[:76] + struct.pack(">I", n) for n in range(1, 17)]
    digests = pow_host.pow_digests(tries, "ethash")
    header = next(h for h, d in zip(tries, digests)
                  if h != bad.header and not tgt.hash_meets_target(d, bad.target))
    forged = sc.Share.from_payload({**bad.to_payload(), "header": header.hex()})
    with pytest.raises(sc.ShareInvalid) as e:
        await pool.submit_share_batch([forged, bad])
    assert e.value.reason == "pow"
    snap = pool.validator.snapshot()
    assert snap["device_batches"] == 2 and snap["rejects"] == 1
    assert pool.stats["verify_failures"] == 0
