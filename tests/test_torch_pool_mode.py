"""The port's pool modes on the CPU: ``Application`` with ``pool.enabled``
mining for itself through its loopback stratum client (shares booked in
SQLite, a block found on a regtest-easy mock chain and its reward
distributed), the same miner against two in-process upstream pools
failing over to the backup with its resume token, ``cli pool --mine``
raising without a card, and the settings whose code is not ported yet
refused by name.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import pytest
import torch

from otedama_tpu.pool.blockchain import MockChainClient as RefMockChainClient
from otedama_tpu_torch import cli
from otedama_tpu_torch.app import Application
from otedama_tpu_torch.config.schema import (
    AppConfig,
    UpstreamConfig,
    load_config,
    validate_config,
)
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.pool.blockchain import MockChainClient
from otedama_tpu_torch.stratum.server import ServerConfig, StratumServer
from otedama_tpu_torch.utils.sha256_host import sha256d

BATCH = 4096
SHARE_DIFFICULTY = 2e-6      # about one share in 8,590 hashes


def _miner_config() -> AppConfig:
    cfg = AppConfig()
    cfg.mining.backend = "torch"
    cfg.mining.device = "cpu"
    cfg.mining.batch_size = BATCH
    cfg.mining.worker_name = "w.card"
    return cfg


async def _until(cond, timeout: float, what):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what()
        await asyncio.sleep(0.02)


@pytest.mark.asyncio
async def test_pool_mode_mines_through_its_loopback_and_books_shares():
    cfg = _miner_config()
    cfg.pool.enabled = True
    cfg.pool.database = ":memory:"
    cfg.stratum.enabled = True
    cfg.stratum.host = "127.0.0.1"
    cfg.stratum.port = 0
    cfg.stratum.initial_difficulty = SHARE_DIFFICULTY
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.05
    chain = MockChainClient(nbits=0x2000FFFF)   # ~1 in 256 hashes is a block
    app = Application(cfg, chain=chain)
    booked = []
    on_share = app_on_share = None
    try:
        await app.start()
        assert app.chain is None and app.pool.chain is chain
        assert app.client is not None and app.client.config.port == app.server.port
        on_share = app.pool.on_share

        async def record(share):
            await on_share(share)
            booked.append(share)

        # the server holds the hook it was built with; count deliveries there
        app.server.on_share = app_on_share = record
        await _until(lambda: chain.submitted and len(booked) >= 3, 60.0,
                     app.snapshot)
        await _until(lambda: any(w["balance"] > 0
                                 for w in app.pool.workers.list()),
                     10.0, app.snapshot)
        snap = app.snapshot()
        rows = app.db.query(
            "SELECT worker, COUNT(*) AS c FROM shares GROUP BY worker")
        accepted = app.client.stats["shares_accepted"]
        rejected = app.client.stats["shares_rejected"]
    finally:
        await app.stop()
    assert app_on_share is not None
    assert set(snap) >= {"engine", "stratum", "pool", "worksource"}
    assert snap["stratum"]["shares_valid"] >= 3
    assert snap["pool"]["blocks"] >= 1
    # every accept the client saw is one booked share row, and no other
    assert rejected == 0
    assert {r["worker"]: r["c"] for r in rows} == {"w.card": len(booked)}
    assert accepted <= len(booked) <= accepted + 1   # one verdict may be in flight
    for s in booked:
        assert sha256d(s.header) == s.digest
        assert tgt.hash_meets_target(
            s.digest, tgt.difficulty_to_target(s.difficulty))
    # the block went to the chain through the pool's submitter, and the
    # reference's chain takes its header
    _, header, block_hash = chain.submitted[0]
    outcome = await RefMockChainClient(nbits=0x2000FFFF).submit_block(header)
    assert outcome.accepted and outcome.block_hash == block_hash
    assert app.engine.state.value == "stopped"


@pytest.mark.asyncio
async def test_pool_without_mining_wires_the_validator_to_the_ledger():
    cfg = AppConfig()
    cfg.mining.enabled = False
    cfg.mining.device = "cpu"
    cfg.pool.enabled = True
    cfg.pool.database = ":memory:"
    cfg.stratum.host = "127.0.0.1"
    cfg.stratum.port = 0
    cfg.validation.enabled = True
    app = Application(cfg, chain=MockChainClient())
    try:
        await app.start()
        assert app.engine is None and app.client is None
        assert app.pool.validator is app.validator
        assert app.server.port != 0 and app.server in app._started
        await _until(lambda: app.server.current_job is not None, 10.0,
                     app.snapshot)
        snap = app.snapshot()
    finally:
        await app.stop()
    assert "validation" in snap["pool"] and snap["stratum"]["sessions"] == 0
    assert app.server._server is None


@pytest.mark.asyncio
async def test_upstream_miner_fails_over_to_the_backup_with_its_token():
    accepted = {"primary": [], "backup": []}
    servers = {}
    for name in ("primary", "backup"):
        async def on_share(s, name=name):
            accepted[name].append(s)

        servers[name] = StratumServer(
            ServerConfig(port=0, initial_difficulty=SHARE_DIFFICULTY,
                         session_secret="shared-secret"),
            on_share=on_share)
        await servers[name].start()
    job_source = MockChainClient()
    from otedama_tpu_torch.pool.manager import PoolManager
    from otedama_tpu_torch.db import connect_database

    db = connect_database(":memory:")
    jobs = PoolManager(db, job_source)
    job = await jobs.next_job()
    for s in servers.values():
        s.set_job(job)
    cfg = _miner_config()
    cfg.upstreams = [
        UpstreamConfig(url=f"127.0.0.1:{servers['primary'].port}",
                       username="w.up", priority=0),
        UpstreamConfig(url=f"stratum+tcp://127.0.0.1:{servers['backup'].port}",
                       username="w.up", priority=1),
    ]
    app = Application(cfg)
    try:
        await app.start()
        assert app.failover.select().name == cfg.upstreams[0].url
        await _until(lambda: accepted["primary"], 60.0, app.snapshot)
        token = app.client.resume_token
        assert token
        await servers["primary"].stop()
        t_stop = time.monotonic()
        while app.failover.select().name != cfg.upstreams[1].url:
            await app.failover.check_all()
            assert time.monotonic() - t_stop < 10.0
        old = app.client
        await app._connect_upstream(app.failover.select())
        assert app.client is not old and app.client in app._started
        assert old not in app._started
        hashes = app.engine.stats.hashes
        await _until(lambda: accepted["backup"], 60.0, app.snapshot)
        assert app.engine.stats.hashes > hashes    # the engine never stopped
        assert app.engine.state.value == "running"
    finally:
        await app.stop()
        await servers["backup"].stop()
        db.close()
    # the resume token rode along: the backup recovered the session
    assert servers["backup"].stats["resumes_accepted"] == 1
    assert all(s.worker_user == "w.up" for s in accepted["backup"])


def test_cli_pool_mine_with_auto_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    monkeypatch.setenv("OTEDAMA_STRATUM_PORT", "0")
    monkeypatch.setenv("OTEDAMA_STRATUM_HOST", "127.0.0.1")
    monkeypatch.setenv("OTEDAMA_POOL_DATABASE", ":memory:")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["pool", "--mine"])
    cfg = load_config(None, environ={})
    assert (cfg.mining.backend, cfg.mining.device) == ("auto", "cuda")


@pytest.mark.parametrize("setting, value, item", [
    ("stratum.workers", 4, "A14"),
    ("stratum.v2_enabled", True, "A14"),
    ("stratum.fleet_listen", "127.0.0.1:0", "A14"),
    ("stratum.fleet_ledger", "127.0.0.1:9", "A14"),
    ("settlement.enabled", True, "A13"),
    ("region.enabled", True, "A13"),
])
def test_settings_of_later_items_are_refused_by_name(setting, value, item):
    cfg = AppConfig()
    section, field = setting.split(".")
    setattr(getattr(cfg, section), field, value)
    errors = validate_config(cfg)
    assert len(errors) == 1 and setting.split(".")[1] in errors[0]
    assert f"ROADMAP {item}" in errors[0]
    env = {f"OTEDAMA_{section.upper()}_{field.upper()}": str(value)}
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        load_config(None, environ=env)


@pytest.mark.parametrize("setting, value, ok", [
    ("p2p.chain_dir", "/var/lib/otedama/chain", True),
    ("p2p.chain_fsync_interval", 0, False),
    ("p2p.chain_segment_bytes", 1024, False),
    ("p2p.chain_snapshot_interval", 0, False),
    ("p2p.chain_tail_shares", 95, False),
    ("p2p.chain_durability", "sync", False),
    ("p2p.chain_durability", "async", True),
    ("p2p.chain_ring_max", 63, False),
])
def test_chain_store_settings_validate_as_the_reference(setting, value, ok):
    """``p2p.chain_dir`` and the store's ``chain_*`` knobs, once refused
    by name, are accepted and validated as the reference validates them,
    from the same defaults."""
    from otedama_tpu.config.schema import AppConfig as RefAppConfig
    from otedama_tpu.config.schema import validate_config as ref_validate

    section, field = setting.split(".")
    knobs = [f.name for f in dataclasses.fields(type(AppConfig().p2p))
             if f.name.startswith("chain_")]
    assert len(knobs) == 7 and [getattr(AppConfig().p2p, k) for k in knobs] \
        == [getattr(RefAppConfig().p2p, k) for k in knobs]
    errors = []
    for make, validate in ((AppConfig, validate_config),
                           (RefAppConfig, ref_validate)):
        cfg = make()
        setattr(getattr(cfg, section), field, value)
        errors.append(validate(cfg))
    assert errors[0] == errors[1]
    assert (errors[0] == []) == ok
    assert ok or field in errors[0][0]
