"""Port parity, the failure layer and the chain RPC client: the
``FailureDetector`` / ``RecoveryManager`` cases of ``tests/test_ops.py``
and the engine-stall recovery of ``tests/test_chaos.py``, the
``HttpConnectionPool`` and ``BitcoinRPCClient`` cases of
``tests/test_pool.py``, each run through both packages with the same
inputs and assertions; then the port's solo ``Application`` mining a
block through ``BitcoinRPCClient`` against a loopback JSON-RPC node.
"""

from __future__ import annotations

import asyncio
import http.server
import json
import threading
import time
import types

import pytest

import otedama_tpu.engine.engine as ref_engine
import otedama_tpu.engine.types as ref_types
import otedama_tpu.pool.blockchain as ref_blockchain
import otedama_tpu.runtime.failure as ref_failure
import otedama_tpu.runtime.search as ref_search
import otedama_tpu.utils.faults as ref_faults
import otedama_tpu.utils.netpool as ref_netpool
import otedama_tpu_torch.engine.engine as port_engine
import otedama_tpu_torch.engine.types as port_types
import otedama_tpu_torch.pool.blockchain as port_blockchain
import otedama_tpu_torch.runtime.failure as port_failure
import otedama_tpu_torch.runtime.search as port_search
import otedama_tpu_torch.utils.faults as port_faults
import otedama_tpu_torch.utils.netpool as port_netpool
from otedama_tpu_torch.app import Application
from otedama_tpu_torch.config.schema import AppConfig
from otedama_tpu_torch.utils.sha256_host import sha256d


def _package(engine, types_, blockchain, failure, search, faults, netpool):
    return types.SimpleNamespace(
        MiningEngine=engine.MiningEngine, EngineConfig=engine.EngineConfig,
        Job=types_.Job, failure=failure, PythonBackend=search.PythonBackend,
        faults=faults, HttpConnectionPool=netpool.HttpConnectionPool,
        BitcoinRPCClient=blockchain.BitcoinRPCClient,
    )


REF = _package(ref_engine, ref_types, ref_blockchain, ref_failure, ref_search,
               ref_faults, ref_netpool)
PORT = _package(port_engine, port_types, port_blockchain, port_failure,
                port_search, port_faults, port_netpool)
PACKAGES = pytest.mark.parametrize("m", [REF, PORT], ids=["jax", "torch"])


class FakeEngine:
    def __init__(self):
        self.hashrate = 1000.0
        self.hashes = 0
        self.state = "running"

    def snapshot(self):
        return {"hashrate": self.hashrate, "hashes": self.hashes,
                "state": self.state, "current_job": "j1"}


# -- tests/test_ops.py: detector and recovery manager ---------------------------

@PACKAGES
def test_detector_flags_hashrate_drop_and_stall(m):
    f = m.failure
    eng = FakeEngine()
    det = f.FailureDetector(eng, f.DetectorConfig(stall_seconds=30.0))
    eng.hashes = 100
    assert det.check(now=1000.0) == []          # establishes peak + progress
    eng.hashrate = 100.0                        # 10% of peak
    found = det.check(now=1010.0)
    assert [x.type for x in found] == [f.FailureType.HASHRATE_DROP]
    found = det.check(now=1050.0)               # no progress for 40 s
    assert f.FailureType.BATCH_STALL in [x.type for x in found]


@PACKAGES
@pytest.mark.asyncio
async def test_detector_runs_matching_strategy_with_cooldown(m):
    f = m.failure
    det = f.FailureDetector(FakeEngine(),
                            f.DetectorConfig(recovery_cooldown=9999.0))
    calls = []

    async def fix(failure):
        calls.append(failure.type)
        return True

    det.add_strategy(f.CallbackStrategy("restart",
                                        (f.FailureType.BATCH_STALL,), fix))
    stall = f.Failure(f.FailureType.BATCH_STALL, "engine", "test")
    assert await det.handle(stall)
    assert det.recoveries == 1 and calls == [f.FailureType.BATCH_STALL]
    assert not await det.handle(stall)          # cooldown
    assert not await det.handle(
        f.Failure(f.FailureType.BACKEND_ERROR, "engine", "x"))
    assert det.failed_recoveries == 1


@PACKAGES
@pytest.mark.asyncio
async def test_recovery_manager_restarts_with_backoff(m):
    mgr = m.failure.RecoveryManager()
    state = {"healthy": False, "restarts": 0}

    async def probe():
        return state["healthy"]

    async def restart():
        state["restarts"] += 1
        if state["restarts"] >= 2:
            state["healthy"] = True

    mgr.register("engine", probe, restart)
    await mgr.check_all(now=1000.0)
    assert state["restarts"] == 1
    await mgr.check_all(now=1000.5)        # inside backoff window
    assert state["restarts"] == 1
    await mgr.check_all(now=1002.0)
    assert state["restarts"] == 2
    result = await mgr.check_all(now=1010.0)
    assert result["engine"] is True
    assert mgr.snapshot()["engine"]["restarts"] == 2


# -- tests/test_chaos.py: an engine.batch stall detected and recovered ----------

def _chaos_job(m, job_id: str):
    return m.Job(
        job_id=job_id, prev_hash=bytes(range(32)),
        coinb1=bytes.fromhex("01000000010000000000000000"),
        coinb2=bytes.fromhex("ffffffff0100f2052a01000000"),
        merkle_branch=[bytes([i] * 32) for i in (7, 9)],
        version=0x20000000, nbits=0x1D00FFFF, ntime=int(time.time()),
        clean=True,
    )


@PACKAGES
@pytest.mark.asyncio
async def test_chaos_engine_stall_detected_and_recovered(m):
    f = m.failure
    engine = m.MiningEngine(
        backends={"py0": m.PythonBackend()},
        config=m.EngineConfig(batch_size=2048, worker_name="w",
                              auto_batch=False, pipeline_depth=1),
    )
    detector = f.FailureDetector(engine, f.DetectorConfig(
        check_interval=0.1, stall_seconds=0.5, recovery_cooldown=5.0,
        max_recovery_attempts=1,
    ))
    restart_lock = asyncio.Lock()

    async def restart(failure) -> bool:
        async with restart_lock:
            await engine.stop()
            await engine.start()
        return True

    detector.add_strategy(f.CallbackStrategy(
        "engine-restart", (f.FailureType.BATCH_STALL,), restart))

    tasks_before = len(asyncio.all_tasks())
    await engine.start()
    engine.set_job(_chaos_job(m, "stall1"))
    try:
        t0 = time.monotonic()
        while engine.stats.hashes == 0:
            await asyncio.sleep(0.02)
            assert time.monotonic() - t0 < 10.0, "engine never hashed"

        inj = m.faults.FaultInjector(11).delay("engine.batch", seconds=60.0,
                                               once=True)
        with m.faults.active(inj):
            await detector.start()
            try:
                t0 = time.monotonic()
                while inj.rules[0].fires == 0:
                    await asyncio.sleep(0.02)
                    assert time.monotonic() - t0 < 5.0
                stalled_at = engine.stats.hashes
                t0 = time.monotonic()
                while detector.recoveries == 0:
                    await asyncio.sleep(0.05)
                    assert time.monotonic() - t0 < 8.0, \
                        "stall never detected/recovered"
                assert any(x.type == f.FailureType.BATCH_STALL
                           for x in detector.failures)
                t0 = time.monotonic()
                while engine.stats.hashes <= stalled_at:
                    await asyncio.sleep(0.05)
                    assert time.monotonic() - t0 < 8.0, \
                        "no progress after recovery"
            finally:
                await detector.stop()
            snap = engine.snapshot()
            assert snap["fault_injection"]["seed"] == 11
            assert snap["fault_injection"]["points"][
                "engine.batch:py0"]["faults"] == 1
            assert detector.snapshot()["recoveries"] == 1
    finally:
        await engine.stop()
    assert "fault_injection" not in engine.snapshot()  # injector gone
    await asyncio.sleep(0.1)
    assert len(asyncio.all_tasks()) <= tasks_before, "leaked engine task"


# -- tests/test_pool.py: the keep-alive pool and the RPC client -----------------

def _serve(handler_cls):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@PACKAGES
def test_http_connection_pool_reuses_and_retries(m):
    connections = []

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive on

        def do_POST(self):
            payload = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            out = json.dumps({"id": payload["id"], "error": None,
                              "result": payload["method"]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def setup(self):
            super().setup()
            connections.append(self.client_address)

        def log_message(self, *a):
            pass

    srv = _serve(Handler)
    try:
        pool = m.HttpConnectionPool(f"http://127.0.0.1:{srv.server_port}/")
        for i in range(8):
            resp = pool.request(
                "POST", "/", json.dumps({"id": i, "method": f"m{i}"}).encode(),
                {"Content-Type": "application/json"})
            assert resp.status == 200
            assert json.loads(resp.body)["result"] == f"m{i}"
        snap = pool.snapshot()
        assert len(connections) == 1, connections
        assert snap["requests"] == 8 and snap["reused"] == 7
        assert snap["opened"] == 1 and snap["errors"] == 0
        assert snap["latency_ema_ms"] > 0

        # a dead keep-alive: the next request replays on a fresh connection
        before = len(connections)
        with pool._lock:
            for _, c in pool._idle:
                c.sock.close()
        resp = pool.request(
            "POST", "/", json.dumps({"id": 99, "method": "after"}).encode(),
            {"Content-Type": "application/json"})
        assert resp.status == 200
        assert pool.snapshot()["retries"] >= 1
        assert len(connections) == before + 1
        pool.close()
    finally:
        srv.shutdown()
        srv.server_close()


@PACKAGES
@pytest.mark.asyncio
async def test_bitcoin_rpc_client_rides_the_pool(m):
    connections = []

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            result = {
                "getblocktemplate": {
                    "version": 0x20000000, "height": 101,
                    "previousblockhash": "00" * 32, "transactions": [],
                    "coinbasevalue": 50_0000_0000, "bits": "1d00ffff",
                    "curtime": 1700000000, "target": "00" * 32,
                },
                "getnetworkinfo": {"version": 250000},
                "getdifficulty": 1.5,
            }.get(req["method"], None)
            out = json.dumps({"id": req["id"], "error": None,
                              "result": result}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def setup(self):
            super().setup()
            connections.append(1)

        def log_message(self, *a):
            pass

    srv = _serve(Handler)
    try:
        client = m.BitcoinRPCClient(
            f"http://127.0.0.1:{srv.server_port}/", user="u", password="p")
        t = await client.get_block_template()
        assert t.height == 101
        assert await client.get_network_difficulty() == 1.5
        await client.get_block_template()
        assert len(connections) == 1  # every RPC shared one connection
        assert client._pool.snapshot()["reused"] == 2
        client.close()
    finally:
        srv.shutdown()
        srv.server_close()


# -- the port's solo Application against a loopback node ------------------------

class MockNode:
    """A JSON-RPC node on a loopback port whose chain is a
    ``MockChainClient``: ``getblocktemplate``, ``submitblock``,
    ``getdifficulty`` and ``getblock``."""

    def __init__(self, chain):
        self.chain = chain
        self.calls: list[str] = []
        self.connections = 0
        node = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                node.connections += 1

            def do_POST(self):
                req = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                out = json.dumps({"id": req["id"], "error": None,
                                  "result": node.answer(req)}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.server = _serve(Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/"

    def answer(self, req):
        method, params = req["method"], req["params"]
        self.calls.append(method)
        chain = self.chain
        if method == "getblocktemplate":
            t = asyncio.run(chain.get_block_template())
            return {"version": t.version, "height": t.height,
                    "previousblockhash": t.prev_hash[::-1].hex(),
                    "bits": f"{t.nbits:08x}", "curtime": t.ntime,
                    "coinbasevalue": t.reward, "transactions": []}
        if method == "submitblock":
            outcome = asyncio.run(chain.submit_block(bytes.fromhex(params[0])))
            return None if outcome.accepted else outcome.reason
        if method == "getdifficulty":
            return asyncio.run(chain.get_network_difficulty())
        if method == "getblock":
            return {"confirmations": asyncio.run(
                chain.get_confirmations(params[0]))}
        raise ValueError(f"unknown method {method}")

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.asyncio
async def test_solo_application_mines_through_the_rpc_client():
    chain = port_blockchain.MockChainClient()   # regtest: half the hashes win
    node = MockNode(chain)
    cfg = AppConfig()
    cfg.mining.backend = "python"
    cfg.mining.batch_size = 256
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.05
    cfg.pool.chain_rpc_url = node.url
    cfg.pool.chain_rpc_user = "u"
    cfg.pool.chain_rpc_password = "p"
    app = Application(cfg)
    try:
        await app.start()
        assert isinstance(app.chain, port_blockchain.BitcoinRPCClient)
        deadline = time.monotonic() + 30.0
        while not chain.submitted:
            assert time.monotonic() < deadline, app.snapshot()
            await asyncio.sleep(0.02)
        snap = app.snapshot()
    finally:
        await app.stop()
        node.close()
    _, header, block_hash = chain.submitted[0]
    assert sha256d(header)[::-1].hex() == block_hash
    assert "getblocktemplate" in node.calls and "submitblock" in node.calls
    assert snap["engine"]["blocks_found"] >= 1
    assert set(snap["failures"]) >= {"failures_detected", "recoveries",
                                     "failed_recoveries"}
    assert snap["recovery"] == {"engine": {"healthy": True, "restarts": 0}}
    # the RPC calls rode keep-alive connections, released at stop
    pool = app.chain.pool_snapshot()
    assert pool["reused"] > 0 and pool["idle"] == 0
    assert app.engine.state.value == "stopped"


def test_supervision_knobs_load_validate_and_reach_the_engine():
    from otedama_tpu.config.schema import AppConfig as RefAppConfig
    from otedama_tpu_torch.config.schema import load_config, validate_config

    ref, port = RefAppConfig().mining, AppConfig().mining
    knobs = ("watchdog_multiplier", "watchdog_floor",
             "watchdog_first_deadline", "max_probes", "drain_timeout")
    assert [getattr(port, k) for k in knobs] == [getattr(ref, k) for k in knobs]
    cfg = load_config(None, environ={
        "OTEDAMA_MINING_BACKEND": "python",
        "OTEDAMA_MINING_WATCHDOG_MULTIPLIER": "3",
        "OTEDAMA_MINING_WATCHDOG_FLOOR": "2.5",
        "OTEDAMA_MINING_WATCHDOG_FIRST_DEADLINE": "10",
        "OTEDAMA_MINING_MAX_PROBES": "4"})
    engine = Application(cfg)._build_engine()
    assert (engine.config.watchdog_multiplier, engine.config.watchdog_floor,
            engine.config.watchdog_first_deadline,
            engine.config.max_probes) == (3.0, 2.5, 10.0, 4)
    for field, value in (("watchdog_floor", 0.0),
                         ("watchdog_first_deadline", -1.0),
                         ("max_probes", -1)):
        bad = AppConfig()
        setattr(bad.mining, field, value)
        assert any(field in e for e in validate_config(bad))
