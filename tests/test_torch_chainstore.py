"""Port parity, the durable share-chain store (``p2p/chainstore.py`` and
the store branches of ``p2p/sharechain.py``, ``p2p/pool.py`` and
``app.py``) against the JAX package's on the CPU.

- the store-only cases of ``tests/test_chainstore.py`` run through both
  packages (parametrised ``jax`` / ``torch``): the file's own test
  functions, executed once as written and once with every
  ``otedama_tpu.`` import pointed at ``otedama_tpu_torch.``. The four
  cases that need ``pool/regions.py`` wait for it (ROADMAP A13);
- one numpy-seeded connect sequence with reorgs, compactions and
  snapshots gives byte-identical segment files and equal snapshots in
  both packages, and each package loads the other's directory to the
  same height, tip, ``weights()`` and archived height;
- the port's ``Application`` as ``cli p2p --mine`` sets it, mining on
  ``TorchBackend(device="cpu")``, is SIGKILLed in a subprocess and
  cold-boots from its directory.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from otedama_tpu.p2p import chainstore as ref_cs
from otedama_tpu.p2p import sharechain as ref_sc
from otedama_tpu.utils import faults as ref_faults
from otedama_tpu_torch.p2p import chainstore as cs
from otedama_tpu_torch.p2p import sharechain as sc
from otedama_tpu_torch.utils import faults
from tests.torch_parity import reference_cases

REPO = Path(__file__).resolve().parents[1]
D = 1e-9
TS_MS = 1_760_000_000_000

# every case of tests/test_chainstore.py but the four that need
# pool/regions.py (its lines 379, 543, 743 and 789)
CASES = (
    "test_segment_log_roundtrip_rotation_and_torn_tail",
    "test_segment_log_mid_file_corruption_stops_iteration",
    "test_journal_truncation_after_snapshot",
    "test_reboot_identical_to_control_and_oracle",
    "test_crash_image_at_every_persist_boundary",
    "test_torn_snapshot_falls_back_to_archive_walk",
    "test_dropped_journal_write_heals_via_locator_sync",
    "test_persist_error_degrades_visibly_not_fatally",
    "test_snapshot_drop_keeps_previous_snapshot",
    "test_archive_boundary_reorg_weights_equal_oracle",
    "test_million_class_window_bounded_memory",
    "test_p2p_pool_compacts_and_persists_on_connect_path",
    "test_chain_metrics_exported",
    "test_app_wires_durable_chain_and_restores_on_boot",
    "test_archived_shares_still_detected_as_duplicates",
    "test_archive_truncation_fails_slices_loudly",
    "test_crash_between_link_and_watermark_converges_to_watermark",
    "test_fsync_error_quarantines_loudly_never_wedges",
    "test_chain_durability_config_validation",
    "test_archive_fallback_refuses_foreign_chain",
)
REGION_CASES = (
    "test_region_dedup_index_rebuilds_from_replay",
    "test_recommit_sweep_forgets_archived_commits",
    "test_ack_mode_never_acks_a_share_the_journal_lost",
    "test_async_mode_acks_immediately_with_bounded_lag",
)

def _cases(package: str):
    return reference_cases("test_chainstore.py", package)


def test_the_cases_are_the_files_store_only_cases():
    names = {n for n in vars(_cases("jax")) if n.startswith("test_")}
    assert names == set(CASES) | set(REGION_CASES)
    torch_mod = _cases("torch")
    assert torch_mod.cs is cs and torch_mod.sc is sc
    assert torch_mod.faults is faults


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", CASES)
def test_chainstore_case(case, package, tmp_path):
    fn = getattr(_cases(package), case)
    args = [tmp_path] if inspect.signature(fn).parameters else []
    result = fn(*args)
    if inspect.iscoroutine(result):
        asyncio.run(result)


def test_fault_registry_lists_the_twenty_points():
    assert sorted(faults.REGISTRY) == sorted([
        "stratum.client.read", "stratum.client.send", "stratum.server.read",
        "stratum.server.write", "region.handoff", "p2p.peer.send",
        "p2p.peer.recv", "p2p.mem.send", "p2p.share.verify", "p2p.sync",
        "chain.persist", "chain.snapshot", "chain.fsync", "db.execute",
        "ledger.flush", "validation.verify", "pool.submitter.submit",
        "pool.failover.check", "engine.batch", "device.call"])
    for point in ("chain.persist", "chain.snapshot", "chain.fsync"):
        port, ref = faults.REGISTRY[point], ref_faults.REGISTRY[point]
        assert (port.location, port.tag, port.supports) == (
            ref.location, ref.tag, ref.supports)


# -- one seeded sequence through both stores -----------------------------------

def _params(m):
    return m.ChainParams(min_difficulty=D, window=8, max_reorg_depth=4,
                         sync_page=5)


def _store(m_cs, path):
    return m_cs.ChainStore(m_cs.ChainStoreConfig(
        path=str(path), fsync_interval=1, snapshot_interval=4,
        tail_shares=6, segment_bytes=4096))


def _sequence(seed: int, steps: int = 70) -> list:
    """A seeded connect order: mostly one share on the tip, and now and
    then a branch from 1-3 shares back that outgrows the tip (a reorg).
    Shares are mined by the reference at a fixed timestamp."""
    rng = np.random.default_rng(seed)
    tracker = ref_sc.ShareChain(_params(ref_sc))
    seq, n = [], 0
    for step in range(steps):
        depth = int(rng.integers(1, 4))
        if rng.random() < 0.2 and tracker.height > depth + 1:
            prev, count = tracker.share_id_at(tracker.height - 1 - depth), depth + 1
        else:
            prev, count = tracker.tip or ref_sc.GENESIS, 1
        for _ in range(count):
            share = ref_sc.mine_share(prev, f"w{int(rng.integers(0, 5))}",
                                      f"j{n}", D, ts_ms=TS_MS + seed)
            n += 1
            assert tracker.connect(share) == "accepted"
            seq.append(share)
            prev = share.share_id
    assert tracker.reorgs > 0
    return seq


def _write(m_sc, m_cs, path, seq):
    chain = m_sc.ShareChain(_params(m_sc), store=_store(m_cs, path))
    assert chain.load()["source"] == "empty"
    for i, share in enumerate(seq):
        assert chain.connect(m_sc.Share.from_payload(share.to_payload())) \
            == "accepted"
        if i % 5 == 4:
            # drained after each pass, so every snapshot the pass queues
            # lands before the next: the files do not depend on timing
            chain.compact()
            assert chain.drain()
    chain.compact()
    assert chain.write_snapshot() and chain.drain()
    state = (chain.height, chain.tip, chain.weights(), chain.archived_height,
             chain.reorgs)
    chain.store.close()
    return state


def _load(m_sc, m_cs, path):
    chain = m_sc.ShareChain(_params(m_sc), store=_store(m_cs, path))
    info = chain.load()
    assert chain.weights() == chain.weights_full()
    state = (chain.height, chain.tip, chain.weights(), chain.archived_height)
    chain.store.close()
    return info["source"], state


@pytest.mark.parametrize("seed", [11, 12])
def test_seeded_sequence_gives_identical_files_and_loads_across(seed,
                                                                 tmp_path):
    seq = _sequence(seed)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_state = _write(ref_sc, ref_cs, ref_dir, seq)
    port_state = _write(sc, cs, port_dir, seq)
    assert port_state == ref_state
    height, tip, weights, archived, reorgs = ref_state
    assert archived > 0 and reorgs > 0
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    assert any(n.startswith("wal-") for n in names)
    assert sum(n.startswith("arc-") for n in names) > 1   # rotated
    assert "snapshot.json" in names
    for name in names:
        a, b = (ref_dir / name).read_bytes(), (port_dir / name).read_bytes()
        if name == "snapshot.json":
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name
    # each package cold-boots the other's directory (and its own)
    for m_sc, m_cs in ((ref_sc, ref_cs), (sc, cs)):
        for path in (ref_dir, port_dir):
            source, state = _load(m_sc, m_cs, path)
            assert source == "snapshot"
            assert state == (height, tip, weights, archived)


def test_frames_equal_the_references(tmp_path):
    share = sc.mine_share(sc.GENESIS, "w", "j", D, ts_ms=TS_MS)
    ref_share = ref_sc.Share.from_payload(share.to_payload())
    payload = cs.encode_extend(7, share, share.share_id, 12345)
    assert payload == ref_cs.encode_extend(7, ref_share, share.share_id, 12345)
    assert cs._frame(cs.REC_EXTEND, payload) == ref_cs._frame(
        ref_cs.REC_EXTEND, payload)
    height, sid, back, cumwork = cs.decode_extend(payload)
    assert (height, sid, back.to_payload(), cumwork) == (
        7, share.share_id, share.to_payload(), 12345)


# -- the port's app killed in a subprocess --------------------------------------

CHILD = r"""
import asyncio, sys
from otedama_tpu_torch.app import Application
from otedama_tpu_torch.config.schema import AppConfig, validate_config

cfg = AppConfig()
# as `cli p2p --mine` sets it, mining on TorchBackend(device="cpu")
cfg.p2p.enabled = cfg.pool.enabled = cfg.mining.enabled = True
cfg.mining.backend, cfg.mining.device = "torch", "cpu"
cfg.mining.batch_size = 4096
cfg.pool.database = ":memory:"
cfg.stratum.enabled, cfg.stratum.host, cfg.stratum.port = True, "127.0.0.1", 0
cfg.stratum.initial_difficulty = 2e-6
cfg.p2p.host, cfg.p2p.port = "127.0.0.1", 0
cfg.p2p.share_difficulty = 1e-9
cfg.p2p.max_reorg_depth = 4
cfg.p2p.pplns_window = 32
cfg.p2p.chain_dir = sys.argv[1]
cfg.p2p.chain_fsync_interval = 4
cfg.p2p.chain_snapshot_interval = 8
cfg.p2p.chain_tail_shares = 16
cfg.api.enabled, cfg.api.port = True, 0
assert validate_config(cfg) == []


async def main():
    app = Application(cfg)
    await app.start()
    chain = app.p2p.chain
    print("boot", chain.height, app.api.port, flush=True)
    i = 0
    while True:
        await app.p2p.announce_share(f"w{i % 3}", 1e-9, f"j{i}")
        await chain.wait_persisted()
        print("persisted", chain.persisted_height(), chain.height, flush=True)
        i += 1

asyncio.run(main())
"""


def _spawn(chain_dir):
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, str(chain_dir)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _scrape(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5.0) as resp:
        return resp.read().decode()


def test_app_killed_mid_stream_cold_boots_from_its_directory(tmp_path):
    chain_dir = tmp_path / "chain"
    proc = _spawn(chain_dir)
    try:
        boot = proc.stdout.readline().split()
        assert boot[:2] == ["boot", "0"], proc.stderr.read()
        persisted = -1
        for line in proc.stdout:
            _, persisted, _height = line.split()
            persisted = int(persisted)
            if persisted >= 300:
                break
        # the API of the live node serves the chain's gauges
        text = _scrape(int(boot[2]), "/api/v1/stats/p2p")
        assert json.loads(text)["chain"]["store"]["persisted_height"] \
            >= persisted
        proc.send_signal(signal.SIGKILL)
        proc.wait(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    proc = _spawn(chain_dir)
    try:
        boot = proc.stdout.readline().split()
        assert boot[0] == "boot", proc.stderr.read()
        assert int(boot[1]) >= persisted + 1
        # it keeps extending past what it restored
        _, after, height = proc.stdout.readline().split()
        assert int(height) == int(boot[1]) + 1
    finally:
        proc.kill()
        proc.wait()

    # the directory, loaded in this process: snapshot + journal suffix,
    # weights equal to the window walk
    from otedama_tpu_torch.p2p.chainstore import ChainStore, ChainStoreConfig

    chain = sc.ShareChain(sc.ChainParams(min_difficulty=1e-9, window=32,
                                         max_reorg_depth=4),
                          store=ChainStore(ChainStoreConfig(
                              path=str(chain_dir), tail_shares=16,
                              snapshot_interval=8)))
    info = chain.load()
    assert info["source"] == "snapshot" and chain.height >= int(height) - 4
    assert chain.archived_height > 0
    assert chain.weights() == chain.weights_full()
    chain.store.close()


@pytest.mark.asyncio
async def test_app_serves_chain_gauges_after_a_cold_boot(tmp_path):
    """A port ``Application`` with ``p2p.chain_dir`` and the API on:
    after a clean stop, a second app restores the chain before its node
    starts, and ``/metrics`` carries the ``otedama_chain_*`` gauges."""
    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig, validate_config

    def make_cfg():
        cfg = AppConfig()
        cfg.mining.enabled = False
        cfg.p2p.enabled = True
        cfg.p2p.host, cfg.p2p.port = "127.0.0.1", 0
        cfg.p2p.share_difficulty = D
        cfg.p2p.chain_dir = str(tmp_path / "chain")
        cfg.p2p.chain_snapshot_interval = 8
        cfg.p2p.chain_tail_shares = 16
        cfg.p2p.max_reorg_depth = 8
        cfg.api.enabled, cfg.api.port = True, 0
        assert validate_config(cfg) == []
        return cfg

    app = Application(make_cfg())
    await app.start()
    try:
        # past the pool's compaction gate (every 256 linked shares)
        for i in range(300):
            await app.p2p.announce_share("alice", D, f"j{i}")
        tip = app.p2p.chain.tip
    finally:
        await app.stop()
    app = Application(make_cfg())
    t0 = time.monotonic()
    await app.start()
    try:
        assert time.monotonic() - t0 < 10.0
        assert (app.p2p.chain.height, app.p2p.chain.tip) == (300, tip)
        assert app.p2p.chain.archived_height > 0
        app.sync_metrics()
        text = await asyncio.to_thread(_scrape, app.api.port, "/metrics")
        for name in ("otedama_chain_archived_height",
                     "otedama_chain_persist_lag",
                     "otedama_chain_persisted_height",
                     "otedama_chain_writer_degraded",
                     "otedama_chain_persist_failures_total",
                     "otedama_p2p_chain_height 300"):
            assert name in text, name
    finally:
        await app.stop()
