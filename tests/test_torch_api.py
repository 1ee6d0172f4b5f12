"""Port parity, the API server and what it stands on (``api/``,
``security/auth.py``, ``utils/logging_setup.py``, the app's ``_start_api``
and metric syncs, ``cli init`` and ``cli status``) against the JAX
package's on the CPU.

- ``tests/test_api_security.py``'s metrics, histogram, JWT, password,
  TOTP, ``AuthManager``, 2FA, websocket and ``sync_rpc_pool_metrics``
  cases and ``tests/test_logs_api.py``'s five cases run through both
  packages (parametrised ``jax`` / ``torch``: the files' own test
  functions, bound to each package);
- the API end to end, the web pages, ``cli init`` and the health,
  metrics and device-state cases of ``tests/test_device_supervision.py``
  are restated for both packages where the two differ (the port's
  algorithm registry, its pages, its benchmark backend);
- the port's ``Application`` serves ``/health``, ``/metrics`` and
  ``/api/v1/status`` from what it runs, ``cli status`` reads it from a
  subprocess, and ``cli p2p --mine`` with a ``chain_dir`` raises without
  a card.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import subprocess
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from tests.torch_parity import reference_cases

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("otedama_tpu", "otedama_tpu_torch")


def _package(name: str) -> types.SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    return types.SimpleNamespace(
        name=name, server=mod("api.server"), auth=mod("security.auth"),
        metrics=mod("api.metrics"), cli=mod("cli"), app=mod("app"),
        schema=mod("config.schema"), algos=mod("engine.algos"),
        supervision=mod("runtime.supervision"))


REF, PORT = _package(PACKAGES[0]), _package(PACKAGES[1])
BOTH = pytest.mark.parametrize("m", [REF, PORT], ids=["jax", "torch"])

SECURITY_CASES = (
    "test_metrics_render_prometheus_text",
    "test_metrics_histogram_render",
    "test_jwt_roundtrip_and_tamper",
    "test_jwt_expiry",
    "test_password_hashing",
    "test_totp_rfc6238_vector",
    "test_auth_manager_login_rbac",
    "test_auth_2fa_required",
    "test_api_websocket_push",
    "test_rpc_pool_metrics_export",
)
LOGS_CASES = (
    "test_memory_log_query_filters",
    "test_logs_api_end_to_end",
    "test_logs_require_auth_when_configured",
    "test_logs_audit_404_when_unwired",
    "test_db_query_audit",
)
# the reference file's imports of what the port does not carry (A16)
SECURITY_DROP = ("from otedama_tpu.security.zkp import SchnorrProver, "
                 "SchnorrVerifier\n",)


def _run(fn, tmp_path):
    import inspect

    args = [tmp_path] if inspect.signature(fn).parameters else []
    result = fn(*args)
    if inspect.iscoroutine(result):
        asyncio.run(result)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", SECURITY_CASES)
def test_api_security_case(case, package, tmp_path):
    _run(getattr(reference_cases("test_api_security.py", package,
                                 SECURITY_DROP), case), tmp_path)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", LOGS_CASES)
def test_logs_api_case(case, package, tmp_path):
    _run(getattr(reference_cases("test_logs_api.py", package), case),
         tmp_path)


# -- restated where the packages differ -----------------------------------------

def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, obj, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


async def _call(fn, *args):
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


@BOTH
@pytest.mark.asyncio
async def test_api_server_end_to_end(m):
    """``tests/test_api_security.py``'s end-to-end case: each package's
    ``/api/v1/algorithms`` lists its own registry."""
    api = m.server.ApiServer(m.server.ApiConfig(port=0,
                                                auth_secret="adminsecret"))
    api.add_provider("engine", lambda: {"hashrate": 123.0, "devices": {}})
    switched = {}

    async def control_switch(params):
        switched.update(params)
        return {"switched": True}

    api.add_control("switch", control_switch)
    api.auth.add_user("admin", "pw", m.auth.Role.ADMIN)
    await api.start()
    base = f"http://127.0.0.1:{api.port}"
    try:
        status, body = await _call(_get, f"{base}/health")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, body = await _call(_get, f"{base}/api/v1/status")
        assert json.loads(body)["engine"]["hashrate"] == 123.0
        status, body = await _call(_get, f"{base}/api/v1/stats/engine")
        assert status == 200 and json.loads(body)["hashrate"] == 123.0
        status, body = await _call(_get, f"{base}/api/v1/stats/nothing")
        assert status == 404
        status, body = await _call(_get, f"{base}/api/v1/algorithms")
        listed = {a["name"]: a for a in json.loads(body)}
        assert set(listed) == set(m.algos.names())
        assert listed["sha256d"]["implemented"] and listed["scrypt"]["memory_hard"]
        api.sync_engine_metrics({"hashrate": 5.0, "devices": {}, "shares": {}})
        status, body = await _call(_get, f"{base}/metrics")
        assert b"otedama_hashrate 5" in body
        status, obj = await _call(_post, f"{base}/api/v1/control/switch",
                                  {"algorithm": "scrypt"})
        assert status == 401
        status, obj = await _call(_post, f"{base}/api/v1/auth/login",
                                  {"username": "admin", "password": "pw"})
        assert status == 200
        status, obj = await _call(
            _post, f"{base}/api/v1/control/switch", {"algorithm": "scrypt"},
            {"Authorization": f"Bearer {obj['token']}"})
        assert status == 200 and obj["ok"] and switched == {"algorithm": "scrypt"}
    finally:
        await api.stop()


def test_algorithm_listings_agree_where_both_carry_the_algorithm():
    port = {n: PORT.algos.get(n) for n in PORT.algos.names()}
    for name, spec in port.items():
        ref = REF.algos.get(name)
        assert (spec.memory_hard, spec.chained) == (ref.memory_hard,
                                                    ref.chained)


@BOTH
@pytest.mark.asyncio
async def test_web_dashboard_and_admin_pages(m):
    """The three pages and the TOTP-gated admin flow; each package serves
    its own copy of the pages."""
    api = m.server.ApiServer(m.server.ApiConfig(port=0,
                                                auth_secret="adminsecret"))
    hit = {}

    async def restart(params):
        hit.update(params or {"restarted": True})
        return {"done": True}

    api.add_control("restart", restart)
    user = api.auth.add_user("root", "hunter2", m.auth.Role.ADMIN,
                             enable_2fa=True)
    await api.start()
    base = f"http://127.0.0.1:{api.port}"
    web = Path(importlib.import_module(m.name).__file__).parent / "web"
    try:
        for path, rel, marker in (
                ("/", "static/index.html", b"mining dashboard"),
                ("/admin", "admin/index.html", b"admin console"),
                ("/admin/login", "admin/login.html", b"otedama-tpu admin")):
            status, body = await _call(_get, base + path)
            assert status == 200 and marker in body, path
            assert body == (web / rel).read_bytes()
        status, body = await _call(_get, f"{base}/api/v1/controls")
        assert json.loads(body) == ["restart"]
        status, obj = await _call(_post, f"{base}/api/v1/auth/login",
                                  {"username": "root", "password": "hunter2"})
        assert status == 401
        status, obj = await _call(
            _post, f"{base}/api/v1/auth/login",
            {"username": "root", "password": "hunter2",
             "totp": m.auth.totp_code(user.totp_secret)})
        assert status == 200
        status, obj = await _call(
            _post, f"{base}/api/v1/control/restart", {},
            {"Authorization": f"Bearer {obj['token']}"})
        assert status == 200 and obj["ok"] and hit == {"restarted": True}
    finally:
        await api.stop()


def test_the_ports_pages_are_its_own_copies():
    port_web = REPO / "otedama_tpu_torch" / "web"
    ref_web = REPO / "otedama_tpu" / "web"
    for rel in ("static/index.html", "admin/index.html", "admin/login.html"):
        port, ref = (port_web / rel).read_text(), (ref_web / rel).read_text()
        # the dashboard names the port's device, and the header comment
        # points at the reference's page; otherwise the same page
        port = port.replace("CUDA mining", "TPU mining")
        assert [line for line in port.splitlines()
                if "Reference parity" not in line] == \
            [line for line in ref.splitlines()
             if "Reference parity" not in line]


@BOTH
def test_cli_init_and_benchmark(m, tmp_path, capsys):
    cfg = tmp_path / "otedama.yaml"
    assert m.cli.main(["-c", str(cfg), "init"]) == 0
    assert m.cli.main(["-c", str(cfg), "init"]) == 1       # refuses overwrite
    assert m.cli.main(["-c", str(cfg), "init", "--force"]) == 0
    loaded = m.schema.load_config(str(cfg), environ={})
    assert m.schema.validate_config(loaded) == []
    assert loaded.api.enabled and loaded.api.port == 8080
    argv = (["benchmark", "-a", "sha256d", "-b", "xla", "-n", "16384"]
            if m is REF else
            ["benchmark", "-a", "sha256d", "-b", "torch", "--device", "cpu",
             "-n", "16384"])
    assert m.cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "sha256d" in out and "benchmarks_h_per_s" in out


def test_cli_init_writes_the_ports_defaults(tmp_path):
    """The port's example file is its defaults with the API turned on."""
    cfg = tmp_path / "otedama.yaml"
    assert PORT.cli.main(["-c", str(cfg), "init"]) == 0
    expect = PORT.schema.AppConfig()
    expect.api.enabled = True
    assert PORT.schema.load_config(str(cfg), environ={}) == expect
    # the file parses the same without pyyaml
    assert PORT.schema._mini_yaml(cfg.read_text()) == \
        __import__("yaml").safe_load(cfg.read_text())


@BOTH
@pytest.mark.asyncio
async def test_health_endpoint_reflects_degraded_capacity(m):
    """``tests/test_device_supervision.py:541``: 200 ok, 200 degraded, 503
    unready, 500 for a broken source."""
    api = m.server.ApiServer()
    assert (await api._health(None)).status == 200
    state = {"status": "degraded", "active_devices": 1, "total_devices": 2}
    api.health_source = lambda: state
    resp = await api._health(None)
    assert resp.status == 200
    assert json.loads(resp.body)["status"] == "degraded"
    assert json.loads(resp.body)["active_devices"] == 1
    state["status"] = "unready"
    assert (await api._health(None)).status == 503

    def boom():
        raise RuntimeError("snapshot exploded")

    api.health_source = boom
    assert (await api._health(None)).status == 500


@BOTH
def test_device_state_names_in_sync(m):
    """``tests/test_device_supervision.py:571``, the ``ApiServer`` half:
    the API's literal device states equal each package's ``DeviceState``,
    and the two packages' equal each other."""
    assert set(m.server.ApiServer._DEVICE_STATES) == {
        s.value for s in m.supervision.DeviceState}
    assert len(m.server.ApiServer._DEVICE_STATES) == len(
        m.supervision.DeviceState)
    assert PORT.server.ApiServer._DEVICE_STATES == \
        REF.server.ApiServer._DEVICE_STATES


@BOTH
def test_metrics_export_device_supervision_families(m):
    """``tests/test_device_supervision.py:611``."""
    api = m.server.ApiServer()
    api.sync_engine_metrics({
        "hashrate": 1.0, "shares": {}, "relayouts": 3,
        "devices": {"cuda0": {
            "hashrate": 1.0, "state": "quarantined", "quarantines": 2,
            "searcher_restarts": 1, "abandoned_calls": 4,
            "call_seconds": {"buckets": {0.1: 5, 1.0: 9}, "sum": 3.5,
                             "count": 9}}}})
    text = api.registry.render()
    for line in ('otedama_device_state{device="cuda0",state="quarantined"} 1',
                 'otedama_device_state{device="cuda0",state="healthy"} 0',
                 'otedama_device_quarantines_total{device="cuda0"} 2',
                 'otedama_device_searcher_restarts_total{device="cuda0"} 1',
                 'otedama_device_abandoned_calls_total{device="cuda0"} 4',
                 'otedama_device_call_seconds_bucket',
                 'otedama_device_relayouts_total 3'):
        assert line in text, line
    api.sync_engine_metrics({"hashrate": 1.0, "shares": {}, "devices": {
        "cuda1": {"hashrate": 1.0, "state": "healthy"}}})
    text = api.registry.render()
    assert 'device="cuda0"' not in text
    assert 'otedama_device_state{device="cuda1",state="healthy"} 1' in text


@BOTH
def test_api_renders_the_same_exposition_for_the_same_snapshots(m):
    """Every sync the port's app runs, fed the same snapshots in both
    packages, renders the same Prometheus text."""
    texts = []
    for pkg in (REF, PORT):
        api = pkg.server.ApiServer()
        api.sync_p2p_metrics({"peers": 3, "shares_rejected": 2,
                              "rejects": {"pow": 2}, "chain": {
                                  "height": 9, "tip_work": 1 << 40}})
        api.sync_chain_metrics({"archived_height": 4, "tail": 5, "store": {
            "persist_lag": 2, "persisted_height": 7, "degraded": False,
            "journal": {"segments": 2, "bytes": 99, "appends": 9}}})
        api.sync_engine_metrics({"hashrate": 7.5, "blocks_found": 1,
                                 "shares": {"found": 4}, "devices": {}})
        texts.append(api.registry.render())
    assert texts[0] == texts[1]
    assert m.server.ApiServer._DEVICE_FAMILIES == \
        REF.server.ApiServer._DEVICE_FAMILIES


# -- the port's app on the CPU ---------------------------------------------------

def _p2p_pool_cfg(chain_dir):
    cfg = PORT.schema.AppConfig()
    cfg.p2p.enabled = cfg.pool.enabled = cfg.mining.enabled = True
    cfg.mining.backend, cfg.mining.device = "torch", "cpu"
    cfg.mining.batch_size = 4096
    cfg.pool.database = ":memory:"
    cfg.stratum.enabled, cfg.stratum.host, cfg.stratum.port = (
        True, "127.0.0.1", 0)
    cfg.stratum.initial_difficulty = 2e-6
    cfg.validation.enabled = True
    cfg.p2p.host, cfg.p2p.port = "127.0.0.1", 0
    cfg.p2p.share_difficulty = 1e-9
    cfg.p2p.chain_dir = str(chain_dir)
    cfg.api.enabled, cfg.api.port = True, 0
    assert PORT.schema.validate_config(cfg) == []
    return cfg


def _cli_status(port: int) -> subprocess.CompletedProcess:
    env = {**os.environ, "OTEDAMA_API_PORT": str(port)}
    return subprocess.run(
        [sys.executable, "-m", "otedama_tpu_torch.cli", "status"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=60)


@pytest.mark.asyncio
async def test_app_api_health_metrics_status_and_cli_status(tmp_path):
    """The port's app as ``cli p2p --mine`` sets it, on the CPU, with the
    API on: ``/health`` follows the engine's devices, the API's engine
    rate is the engine's, the ``otedama_chain_*`` and validation gauges
    are sampled, and ``cli status`` in another process reads
    ``/api/v1/status``."""
    app = PORT.app.Application(_p2p_pool_cfg(tmp_path / "chain"))
    await app.start()
    try:
        assert set(app.api.providers) == {
            "engine", "upstream", "stratum", "pool", "p2p", "benchmarks",
            "fault_injection", "failures", "recovery"}
        assert app.api.audit_source == app.db.query_audit
        loop_deadline = asyncio.get_running_loop().time() + 60
        while app.engine.state.value != "running":
            assert asyncio.get_running_loop().time() < loop_deadline
            await asyncio.sleep(0.05)
        for i in range(3):
            await app.p2p.announce_share("alice", 1e-9, f"j{i}")
        await app.p2p.chain.wait_persisted()
        base = f"http://127.0.0.1:{app.api.port}"
        status, body = await _call(_get, f"{base}/health")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert set(health["device_states"].values()) == {"healthy"}
        app.sync_metrics()
        rate = app.engine.snapshot()["hashrate"]
        status, body = await _call(_get, f"{base}/metrics")
        text = body.decode()
        assert f"otedama_hashrate {rate:g}" in text or (
            f"otedama_hashrate {int(rate)}" in text)
        for name in ("otedama_chain_persist_lag 0",
                     "otedama_chain_persisted_height 2",
                     "otedama_chain_writer_degraded 0",
                     "otedama_chain_persist_failures_total 0",
                     "otedama_p2p_chain_height 3",
                     "otedama_validation_device_ok 1"):
            assert name in text, name
        done = await _call(_cli_status, app.api.port)
        assert done.returncode == 0, done.stderr
        status_doc = json.loads(done.stdout)
        assert status_doc["p2p"]["chain"]["height"] == 3
        assert status_doc["engine"]["algorithm"] == "sha256d"
        assert status_doc["fault_injection"] == {"active": False}
    finally:
        await app.stop()
    done = await _call(_cli_status, app.api.port)
    assert done.returncode == 1 and "cannot reach" in done.stderr


def test_cli_p2p_mine_with_a_chain_dir_raises_without_a_card(monkeypatch,
                                                             tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    for key, value in (("STRATUM_PORT", "0"), ("STRATUM_HOST", "127.0.0.1"),
                       ("POOL_DATABASE", ":memory:"), ("P2P_PORT", "0"),
                       ("P2P_HOST", "127.0.0.1"), ("API_PORT", "0"),
                       ("API_ENABLED", "true"),
                       ("P2P_CHAIN_DIR", str(tmp_path / "chain"))):
        monkeypatch.setenv(f"OTEDAMA_{key}", value)
    with pytest.raises(RuntimeError, match="cuda"):
        PORT.cli.main(["p2p", "--mine"])
