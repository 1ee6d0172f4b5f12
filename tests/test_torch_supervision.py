"""Port parity, device supervision: watchdog deadlines, quarantine,
verified probes, extranonce2 relayout and the warm algorithm switch, run
through the JAX package's ``MiningEngine`` and the port's with the same
pure-python backends, seeds and knobs.

The first eight cases are the non-pod cases of
``tests/test_device_supervision.py``, parametrised over both packages
with the same assertions on state transitions, counters, health and
shares. Then the deterministic pieces are compared value for value: the
supervisor's state machine and deadline model under one scripted
sequence, the probe jobs, the host oracle's probe winners and the
corrupt fault mode; and one warm switch runs through both engines.
"""

from __future__ import annotations

import asyncio
import threading
import time
import types
from contextlib import asynccontextmanager

import pytest
import torch

import otedama_tpu.engine.engine as ref_engine
import otedama_tpu.engine.jobs as ref_jobs
import otedama_tpu.engine.types as ref_types
import otedama_tpu.kernels.target as ref_target
import otedama_tpu.runtime.failure as ref_failure
import otedama_tpu.runtime.search as ref_search
import otedama_tpu.runtime.supervision as ref_supervision
import otedama_tpu.utils.faults as ref_faults
import otedama_tpu_torch.engine.engine as port_engine
import otedama_tpu_torch.engine.jobs as port_jobs
import otedama_tpu_torch.engine.types as port_types
import otedama_tpu_torch.kernels.target as port_target
import otedama_tpu_torch.runtime.failure as port_failure
import otedama_tpu_torch.runtime.search as port_search
import otedama_tpu_torch.runtime.supervision as port_supervision
import otedama_tpu_torch.utils.faults as port_faults


def _package(engine, jobs, types_, target, failure, search, supervision,
             faults):
    return types.SimpleNamespace(
        MiningEngine=engine.MiningEngine, EngineConfig=engine.EngineConfig,
        Job=types_.Job, job_constants=jobs.job_constants, tgt=target,
        FailureDetector=failure.FailureDetector,
        FailureType=failure.FailureType, search=search,
        PythonBackend=search.PythonBackend, SearchResult=search.SearchResult,
        Winner=search.Winner, scalar_search=search._scalar_search,
        supervision=supervision, faults=faults,
    )


REF = _package(ref_engine, ref_jobs, ref_types, ref_target, ref_failure,
               ref_search, ref_supervision, ref_faults)
PORT = _package(port_engine, port_jobs, port_types, port_target, port_failure,
                port_search, port_supervision, port_faults)
PACKAGES = pytest.mark.parametrize("m", [REF, PORT], ids=["jax", "torch"])

# easy target: ~1 winner per 4096 nonces — shares flow fast on the
# pure-python backends without swamping the submit path
EASY_TARGET = (1 << 256) - 1 >> 12


def make_job(m, jid: str, **kw):
    defaults = dict(
        job_id=jid, prev_hash=bytes(32), coinb1=b"\x01" * 8,
        coinb2=b"\x02" * 8, merkle_branch=[], version=0x20000000,
        nbits=0x1D00FFFF, ntime=1700000000, extranonce1=b"\xaa\xbb",
        extranonce2_size=4, share_target=EASY_TARGET, algorithm="sha256d",
    )
    defaults.update(kw)
    return m.Job(**defaults)


def fast_config(m, **kw):
    """The reference tests' test-speed supervision knobs."""
    defaults = dict(
        batch_size=512, auto_batch=False, pipeline_depth=1,
        watchdog_multiplier=3.0, watchdog_floor=0.3,
        watchdog_first_deadline=0.4, watchdog_min_samples=1,
        probe_timeout=0.5, probe_backoff=0.05, probe_backoff_max=0.2,
        max_probes=50, probe_count=64, drain_timeout=2.0,
        searcher_restart_backoff=0.02, searcher_restart_backoff_max=0.1,
    )
    defaults.update(kw)
    return m.EngineConfig(**defaults)


def py_backends(m, n: int) -> dict:
    out = {}
    for i in range(n):
        b = m.PythonBackend()
        b.name = f"py{i}"
        out[f"py{i}"] = b
    return out


async def wait_until(cond, timeout: float, what: str) -> None:
    t0 = time.monotonic()
    while not cond():
        await asyncio.sleep(0.02)
        assert time.monotonic() - t0 < timeout, f"timed out waiting: {what}"


@asynccontextmanager
async def running(engine):
    """Start the engine; ALWAYS stop it."""
    await engine.start()
    try:
        yield engine
    finally:
        if engine.state.value != "stopped":
            await engine.stop()


@asynccontextmanager
async def faults_active(m, inj):
    with m.faults.active(inj):
        yield inj


# -- the eight non-pod cases of tests/test_device_supervision.py ---------------

@PACKAGES
@pytest.mark.asyncio
async def test_hang_quarantine_probe_reintegrate_lifecycle(m):
    shares = []

    async def on_share(s):
        shares.append(s)

    engine = m.MiningEngine(py_backends(m, 3), on_share=on_share,
                            config=fast_config(m))
    inj = m.faults.FaultInjector(1337).delay(
        "device.call:py1", seconds=1.5, window=(0.0, 1.0)
    )
    job = make_job(m, "life-1")
    async with running(engine), faults_active(m, inj):
        engine.set_job(job)
        sup = engine.supervisors["py1"]

        await wait_until(lambda: not sup.can_mine, 3.0, "quarantine")
        quarantined_at = time.monotonic()
        snap = engine.snapshot()
        assert snap["devices"]["py1"]["state"] in ("quarantined", "probing")
        assert snap["devices"]["py1"]["quarantines"] == 1
        assert snap["devices"]["py1"]["watchdog_timeouts"] >= 1
        assert snap["abandoned_calls"] >= 1
        assert snap["supervision"]["status"] == "degraded"
        assert snap["supervision"]["active_devices"] == 2

        h0 = (snap["devices"]["py0"]["hashes"]
              + snap["devices"]["py2"]["hashes"])
        await asyncio.sleep(0.3)
        snap2 = engine.snapshot()
        assert (snap2["devices"]["py0"]["hashes"]
                + snap2["devices"]["py2"]["hashes"]) > h0

        await wait_until(
            lambda: sup.state.value == "healthy", 6.0, "reintegration"
        )
        assert time.monotonic() - quarantined_at < 6.0
        assert sup.reintegrations == 1
        py1_hashes = engine.snapshot()["devices"]["py1"]["hashes"]
        await wait_until(
            lambda: engine.snapshot()["devices"]["py1"]["hashes"] > py1_hashes,
            3.0, "py1 mining after reintegration",
        )
        snap3 = engine.snapshot()
        assert snap3["supervision"]["status"] == "ok"
        assert snap3["relayouts"] >= 2  # quarantine exit + rejoin
        await engine.stop()

    assert shares, "survivors produced no shares"
    seen = set()
    for s in shares:
        key = (s.job_id, s.extranonce2, s.nonce_word)
        assert key not in seen, "duplicate share emitted"
        seen.add(key)
        jc = m.job_constants(job, s.extranonce2)
        assert s.digest == jc.digest_for(s.nonce_word)
        assert m.tgt.hash_meets_target(s.digest, jc.target)
    assert engine.stats.shares_found == len(shares)


@PACKAGES
@pytest.mark.asyncio
async def test_stop_bounded_with_permanently_hung_call(m):
    engine = m.MiningEngine(
        py_backends(m, 1),
        config=fast_config(m, drain_timeout=0.3, watchdog_first_deadline=10.0,
                           watchdog_multiplier=50.0, watchdog_floor=10.0),
    )
    inj = m.faults.FaultInjector(5).delay("device.call:py0", seconds=2.5)
    async with running(engine), faults_active(m, inj):
        engine.set_job(make_job(m, "hang-stop"))
        await wait_until(lambda: inj.rules[0].fires >= 1, 3.0, "fault armed")
        t0 = time.monotonic()
        await engine.stop()
        elapsed = time.monotonic() - t0
    assert elapsed < 1.5, f"stop() took {elapsed:.2f}s with a hung call"
    snap = engine.snapshot()
    assert snap["abandoned_calls"] >= 1
    assert engine.state.value == "stopped"


@PACKAGES
@pytest.mark.asyncio
async def test_searcher_restarts_on_backend_error(m):
    engine = m.MiningEngine(py_backends(m, 1), config=fast_config(m))
    inj = m.faults.FaultInjector(23).error(
        "device.call:py0", window=(0.0, 0.3)
    )
    async with running(engine), faults_active(m, inj):
        engine.set_job(make_job(m, "err-restart"))
        sup = engine.supervisors["py0"]
        await wait_until(lambda: sup.searcher_restarts >= 2, 3.0,
                         "searcher restarts")
        await wait_until(
            lambda: engine.snapshot()["devices"]["py0"]["hashes"] > 0,
            4.0, "mining resumed",
        )
        snap = engine.snapshot()
        assert snap["devices"]["py0"]["searcher_restarts"] >= 2
        assert snap["devices"]["py0"]["state"] == "healthy"


@PACKAGES
@pytest.mark.asyncio
async def test_probe_rejects_wrong_results_until_window_closes(m):
    engine = m.MiningEngine(py_backends(m, 1), config=fast_config(m))
    inj = (
        m.faults.FaultInjector(77)
        .delay("device.call:py0", seconds=1.0, once=True)   # trigger
        .corrupt("device.call:py0", window=(0.0, 1.0))      # poison probes
    )
    async with running(engine), faults_active(m, inj):
        engine.set_job(make_job(m, "probe-corrupt"))
        sup = engine.supervisors["py0"]
        await wait_until(lambda: not sup.can_mine, 3.0, "quarantine")
        await wait_until(lambda: sup.probes_failed >= 1, 3.0,
                         "corrupted probe rejected")
        assert "oracle" in (sup.last_error or "")
        assert sup.state.value in ("quarantined", "probing")
        await wait_until(lambda: sup.state.value == "healthy", 6.0,
                         "reintegration after corruption window")
        assert sup.reintegrations == 1


@PACKAGES
@pytest.mark.asyncio
async def test_dead_after_probe_budget_and_detector_failures(m):
    engine = m.MiningEngine(
        py_backends(m, 2),
        config=fast_config(m, max_probes=2, probe_timeout=0.2,
                           probe_backoff=0.03, probe_backoff_max=0.05),
    )
    detector = m.FailureDetector(engine)
    inj = m.faults.FaultInjector(9).delay("device.call:py1", seconds=3.0)
    async with running(engine), faults_active(m, inj):
        engine.set_job(make_job(m, "dead-dev"))
        sup = engine.supervisors["py1"]
        found = []
        await wait_until(
            lambda: (found.extend(detector.check()) or
                     sup.state.value == "dead"),
            8.0, "device death",
        )
        found.extend(detector.check())
        device_failures = [
            f for f in found
            if f.type in (m.FailureType.DEVICE_HUNG, m.FailureType.DEVICE_LOST)
        ]
        kinds = [f.type for f in device_failures]
        assert kinds.count(m.FailureType.DEVICE_HUNG) == 1
        assert kinds.count(m.FailureType.DEVICE_LOST) == 1
        assert [f.component for f in device_failures] == ["py1", "py1"]

        health = engine.device_health()
        assert health["status"] == "degraded"
        assert health["active_devices"] == 1
        assert health["device_states"]["py1"] == "dead"
        h0 = engine.snapshot()["devices"]["py0"]["hashes"]
        await wait_until(
            lambda: engine.snapshot()["devices"]["py0"]["hashes"] > h0,
            3.0, "survivor mining",
        )
        t0 = time.monotonic()
        await engine.stop()
        assert time.monotonic() - t0 < 2 * engine.config.drain_timeout + 1.0


class FullSpaceBackend:
    """Fake device: one call covers the whole 2^32 nonce space, so the
    engine rolls to the device's next extranonce2 block every call; the
    single winner's nonce is the device index."""

    preferred_batch = 1 << 32

    def __init__(self, m, name: str, index: int):
        self.m = m
        self.name = name
        self.index = index
        self.calls = 0

    def search(self, jc, base, count):
        self.calls += 1
        time.sleep(0.004)  # keep the en2 roll rate bounded
        return self.m.SearchResult(
            [self.m.Winner(self.index, jc.digest_for(self.index))], count,
            0xFFFFFFFF,
        )


@PACKAGES
@pytest.mark.asyncio
async def test_en2_blocks_disjoint_and_reassigned_after_quarantine(m):
    backends = {f"r{i}": FullSpaceBackend(m, f"r{i}", i) for i in range(3)}
    shares = []

    async def on_share(s):
        shares.append(s)

    engine = m.MiningEngine(
        backends, on_share=on_share,
        config=m.EngineConfig(
            batch_size=1 << 32, auto_batch=True, pipeline_depth=1,
            watchdog_multiplier=3.0, watchdog_floor=0.3,
            watchdog_first_deadline=0.4, watchdog_min_samples=1,
            probe_timeout=0.3, probe_backoff=1.0, probe_backoff_max=1.0,
            max_probes=1, probe_count=16, drain_timeout=1.0,
        ),
    )
    inj = m.faults.FaultInjector(3).delay("device.call:r2", seconds=1.5)
    async with running(engine):
        engine.set_job(make_job(m, "layout-1"))
        await wait_until(lambda: len(shares) >= 9, 5.0, "phase-1 shares")
        for s in [s for s in shares if s.job_id == "layout-1"]:
            en2 = int.from_bytes(s.extranonce2, "big")
            assert en2 % 3 == s.nonce_word, (
                f"device {s.nonce_word} mined en2 {en2} outside its block"
            )

        with m.faults.active(inj):
            sup = engine.supervisors["r2"]
            await wait_until(lambda: not sup.can_mine, 4.0, "r2 quarantine")
            await wait_until(lambda: engine._relayouts >= 1, 2.0, "relayout")
            shares.clear()
            engine.set_job(make_job(m, "layout-2"))
            await wait_until(
                lambda: len(
                    [s for s in shares if s.job_id == "layout-2"]
                ) >= 8,
                5.0, "phase-2 shares",
            )
            en2_by_dev: dict[int, set] = {}
            for s in [s for s in shares if s.job_id == "layout-2"]:
                en2 = int.from_bytes(s.extranonce2, "big")
                en2_by_dev.setdefault(s.nonce_word, set()).add(en2)
            assert set(en2_by_dev) == {0, 1}, "quarantined r2 kept mining"
            for en2s in en2_by_dev.values():
                assert len({e % 2 for e in en2s}) == 1
            assert (en2_by_dev[0] | en2_by_dev[1]) >= {0, 1, 2, 3}, (
                "old r2 block (en2=2 under the 3-way layout) was orphaned"
            )


@PACKAGES
def test_device_call_corrupt_action_and_supports_gate(m):
    sv = m.supervision
    jc = sv.probe_job_constants()
    res = m.scalar_search(jc, sv.PROBE_BASE, 64, jc.digest_for)
    assert res.winners, "probe target must guarantee winners"
    mangled = sv.corrupt_result(res)
    assert [w.nonce_word for w in mangled.winners] == \
        [w.nonce_word for w in res.winners]
    assert all(mw.digest != w.digest
               for mw, w in zip(mangled.winners, res.winners))
    assert not sv.verify_probe_results("sha256d", jc, mangled,
                                       sv.PROBE_BASE, 64)
    assert sv.verify_probe_results("sha256d", jc, res, sv.PROBE_BASE, 64)
    assert sv.corrupt_result(m.SearchResult([], 16, 0xFFFFFFFF)).winners

    # supports gate: drop is not applicable to device.call
    inj = m.faults.FaultInjector(1).drop("device.call")
    assert inj.hit("device.call", "py0", m.faults.DEVICE) is None
    assert inj.rules[0].fires == 0
    # corrupt IS applicable, and only where declared (db.execute is a
    # point both packages register)
    inj2 = m.faults.FaultInjector(1).corrupt("device.call")
    d = inj2.hit("device.call", "py0", m.faults.DEVICE)
    assert d is not None and d.corrupt
    assert inj2.hit("db.execute", None, m.faults.POINT) is None
    assert {"device.call", "engine.batch"} <= set(m.faults.REGISTRY)


@PACKAGES
def test_probe_verification_structural_for_non_oracle_algorithms(m):
    sv = m.supervision
    jc = sv.probe_job_constants("ethash")
    good = m.SearchResult([m.Winner(sv.PROBE_BASE + 1, b"\x01" + b"\x00" * 31)],
                          64, 0xFFFFFFFF)
    assert sv.verify_probe_results("ethash", jc, good, sv.PROBE_BASE, 64)
    assert not sv.verify_probe_results(
        "ethash", jc, sv.corrupt_result(good), sv.PROBE_BASE, 64)
    bad = m.SearchResult(
        [m.Winner(sv.PROBE_BASE + 4096, b"\x01" + b"\x00" * 31)],
        64, 0xFFFFFFFF)
    assert not sv.verify_probe_results("ethash", jc, bad, sv.PROBE_BASE, 64)


# -- deterministic equivalence --------------------------------------------------

def test_device_state_names_equal():
    """The half of test_device_supervision's state-name pin that needs
    no API server: the port's states are the reference's."""
    assert [(s.name, s.value) for s in port_supervision.DeviceState] == \
        [(s.name, s.value) for s in ref_supervision.DeviceState]


def _scripted(m) -> list:
    """One scripted sequence through a supervisor: snapshots (without
    timestamps) and deadlines after every step."""
    cfg = m.EngineConfig(watchdog_multiplier=3.0, watchdog_floor=0.3,
                         watchdog_first_deadline=7.0, watchdog_min_samples=2,
                         probe_backoff=0.25, probe_backoff_max=2.0)
    sup = m.supervision.DeviceSupervisor("dev0", cfg)
    probe = ("probe", 256)
    steps = [
        lambda: sup.observe_call(1024, 0.5),
        lambda: sup.observe_call(1024, 0.2),
        lambda: sup.observe_call(2048, 1.7),
        lambda: sup.on_hung("device dev0: call exceeded its 1.4s deadline"),
        lambda: sup.observe_call(1024, 90.0),      # a hung call lands late
        lambda: sup.begin_probe(),
        lambda: sup.observe_call(probe, 0.8),
        lambda: sup.probe_failed("probe results failed host-oracle "
                                 "verification"),
        lambda: sup.begin_probe(),
        lambda: sup.probe_interrupted(),
        lambda: sup.begin_probe(),
        lambda: sup.reintegrate(),
        lambda: sup.observe_call(1024, 0.4),
        lambda: sup.on_hung("second hang"),
        lambda: sup.begin_probe(),
        lambda: sup.probe_failed("timeout"),
        lambda: sup.mark_dead(),
        lambda: sup.reset_state(),
    ]
    out = []
    for step in steps:
        step()
        snap = sup.snapshot()
        snap["transitions"] = [{k: v for k, v in t.items() if k != "at"}
                               for t in snap["transitions"]]
        out.append((snap, sup.deadline(1024), sup.deadline(2048),
                    sup.deadline(probe), sup.deadline(4096),
                    sup.next_probe_delay(), sup.can_mine,
                    sup.has_samples(probe)))
    return out


def test_supervisor_state_machine_equal():
    assert _scripted(PORT) == _scripted(REF)


@pytest.mark.parametrize("algorithm", ["sha256d", "scrypt", "x11", "ethash"])
def test_probe_job_constants_equal(algorithm):
    a = port_supervision.probe_job_constants(algorithm)
    b = ref_supervision.probe_job_constants(algorithm)
    assert (a.header76, a.target, tuple(a.midstate), tuple(a.tail),
            a.block_number) == (b.header76, b.target, tuple(b.midstate),
                                tuple(b.tail), b.block_number)
    assert list(a.limbs) == list(b.limbs)
    assert port_supervision.PROBE_BASE == ref_supervision.PROBE_BASE


@pytest.mark.parametrize("algorithm", ["sha256d", "scrypt"])
def test_expected_probe_winners_equal(algorithm):
    base = port_supervision.PROBE_BASE
    got = port_supervision.expected_probe_winners(
        algorithm, port_supervision.probe_job_constants(algorithm), base, 64)
    want = ref_supervision.expected_probe_winners(
        algorithm, ref_supervision.probe_job_constants(algorithm), base, 64)
    assert got and got == want


def test_corrupt_result_equal():
    jc = port_supervision.probe_job_constants()
    base = port_supervision.PROBE_BASE
    port_res = port_search._scalar_search(jc, base, 48, jc.digest_for)
    ref_res = ref_search._scalar_search(jc, base, 48, jc.digest_for)

    def rows(obj):
        return [(r.hashes, r.best_hash_hi,
                 [(w.nonce_word, w.digest) for w in r.winners]) for r in obj]

    empty = (port_search.SearchResult([], 16, 7), ref_search.SearchResult([], 16, 7))
    assert rows(port_supervision.corrupt_result([port_res, empty[0]])) == \
        rows(ref_supervision.corrupt_result([ref_res, empty[1]]))
    got = port_supervision.corrupt_result((jc, port_res))
    want = ref_supervision.corrupt_result((jc, ref_res))
    assert got[0] is jc and rows([got[1]]) == rows([want[1]])


def test_probe_cuda_devices_returns_devices_that_answer():
    cpu = torch.device("cpu")
    assert port_supervision.probe_cuda_devices([cpu], timeout=5.0) == [cpu]
    assert port_supervision.probe_cuda_devices([], timeout=5.0) == []


# -- the warm switch through both engines --------------------------------------

class SwitchStub:
    """A backend of one algorithm: no winners; while ``gate`` is clear
    every call waits on it. ``close()`` records how many calls were still
    running when it came."""

    def __init__(self, name: str, algorithm: str, m):
        self.name, self.algorithm, self.m = name, algorithm, m
        self.gate = threading.Event()
        self.gate.set()
        self.lock = threading.Lock()
        self.calls = 0
        self.active = 0
        self.closes: list[int] = []

    def search(self, jc, base, count):
        with self.lock:
            self.calls += 1
            self.active += 1
        try:
            assert self.gate.wait(10.0), "the test never opened the gate"
            time.sleep(0.002)
            return self.m.SearchResult([], count, 0xFFFFFFFF)
        finally:
            with self.lock:
                self.active -= 1

    def close(self):
        with self.lock:
            self.closes.append(self.active)


async def _warm_switch(m) -> dict:
    old = SwitchStub("old", "sha256d", m)
    dead = SwitchStub("dead", "sha256d", m)
    new = SwitchStub("new", "scrypt", m)
    engine = m.MiningEngine({"old": old, "dead": dead},
                            config=fast_config(m, drain_timeout=5.0))
    out = {}
    async with running(engine):
        engine.set_job(make_job(m, "sha-1"))
        await wait_until(lambda: old.calls >= 3, 3.0, "old mining")
        engine.supervisors["dead"].mark_dead()
        old.gate.clear()
        entered = old.calls
        # a call that began after the gate closed waits on it
        await wait_until(lambda: old.calls > entered, 3.0, "a call in flight")
        switch = asyncio.create_task(
            engine.switch_algorithm("scrypt", {"new": new}))
        await wait_until(lambda: engine.backends.get("new") is new, 3.0,
                         "new backend set")
        # the old backend's call is still in flight: not closed yet
        await asyncio.sleep(0.1)
        out["closed_before_drain"] = list(old.closes)
        out["job_after_switch"] = engine._job
        engine.set_job(make_job(m, "sha-late"))        # old algorithm
        out["old_job_refused"] = engine._job is None
        old.gate.set()
        downtime = await switch
        out["downtime_bounded"] = 0.0 <= downtime < 1.0
        out["closes"] = list(old.closes)
        out["supervisors"] = sorted(engine.supervisors)
        out["states"] = engine.device_health()["device_states"]
        out["stats_devices"] = sorted(engine.stats.devices)
        snap = engine.snapshot()
        out["switches"] = snap["switches"]
        out["algorithm"] = snap["algorithm"]
        engine.set_job(make_job(m, "scrypt-1", algorithm="scrypt"))
        await wait_until(lambda: new.calls >= 3, 3.0, "new mining")
    return out


@pytest.mark.asyncio
async def test_warm_switch_equal():
    got = await _warm_switch(PORT)
    want = await _warm_switch(REF)
    assert got == want
    assert got["closed_before_drain"] == []
    assert got["job_after_switch"] is None and got["old_job_refused"]
    assert got["downtime_bounded"]
    assert got["closes"] == [0]          # once, after its call drained
    assert got["supervisors"] == ["dead", "new"]   # pruned, tombstone kept
    assert got["states"] == {"new": "healthy", "dead": "dead"}
    assert got["stats_devices"] == ["new"]
    assert (got["switches"], got["algorithm"]) == (1, "scrypt")


# -- closing a card backend -----------------------------------------------------

class FakeStream:
    """Stands in for a card stream: busy for ``busy`` polls of query()."""

    def __init__(self, busy: int):
        self.busy = busy
        self.polls = 0

    def query(self) -> bool:
        self.polls += 1
        return self.polls > self.busy


def _closable(cls, stream):
    """A card backend's host side around a fake stream: the close protocol
    (the closed flag under the enqueue lock, the wait for the stream, the
    release) runs on the CPU; a launch would need the card."""
    backend = object.__new__(cls)
    if cls is port_search.CudaBackend:
        port_search._BufferBackend.__init__(backend, "cpu", None)
    else:
        port_search._ScryptBackend.__init__(backend, "cpu", None, 64)
        backend.tier, backend.name = "romix", "scrypt-cuda"
        backend._scratch = ("rows", "V")
    backend.stream = stream
    backend._lock = threading.Lock()
    backend._closed = False
    return backend


@pytest.mark.parametrize("cls", [port_search.CudaBackend,
                                 port_search.ScryptCudaBackend],
                         ids=["sha256d", "scrypt"])
def test_a_closed_card_backend_refuses_calls(cls, monkeypatch):
    monkeypatch.setattr(port_search.sc, "load_library", lambda: None)
    monkeypatch.setattr(port_search.scc, "load_library", lambda: None)
    stream = FakeStream(busy=3)
    backend = _closable(cls, stream)
    backend.close(timeout=5.0)
    # close waited for the launches queued on the stream before releasing
    assert stream.polls == 4
    if cls is port_search.ScryptCudaBackend:
        assert backend._scratch is None
    jc = port_supervision.probe_job_constants()
    with pytest.raises(port_search.BackendClosedError):
        backend.search(jc, 0, 16)
    with pytest.raises(port_search.BackendClosedError):
        backend.precompile(count=16)
    if cls is port_search.CudaBackend:
        with pytest.raises(port_search.BackendClosedError):
            backend.search_group(jc, [(0, 16), (16, 16)])
    backend.close(timeout=5.0)            # a second close is a no-op
    assert stream.polls == 4


def test_close_keeps_the_scratch_of_a_stream_that_never_drains():
    backend = _closable(port_search.ScryptCudaBackend, FakeStream(busy=10**9))
    backend.close(timeout=0.05)
    # V must not be freed under a kernel still running on it
    assert backend._scratch == ("rows", "V") and backend._closed
    with pytest.raises(port_search.BackendClosedError):
        backend.search(port_supervision.probe_job_constants("scrypt"), 0, 8)


# -- a job change right after a relayout ----------------------------------------

class AllowedStub:
    """Each call covers a whole extranonce2 space and waits for an
    allowance first; its one winner is nonce 7, with its real digest."""

    name = "a"
    preferred_batch = 1 << 32

    def __init__(self, m):
        self.m = m
        self.allow = threading.Semaphore(0)

    def search(self, jc, base, count):
        assert self.allow.acquire(timeout=10.0), "the test never allowed it"
        return self.m.SearchResult([self.m.Winner(7, jc.digest_for(7))],
                                   count, 0xFFFFFFFF)


async def _relayout_then_job_change(m) -> list:
    stub = AllowedStub(m)
    shares = []

    async def on_share(s):
        shares.append((s.job_id, s.extranonce2, s.nonce_word))

    engine = m.MiningEngine({"a": stub}, on_share=on_share, config=fast_config(
        m, batch_size=1 << 32, auto_batch=True, watchdog_multiplier=0.0))
    async with running(engine):
        engine.set_job(make_job(m, "J"))
        stub.allow.release()                       # extranonce2 0 of J
        await wait_until(lambda: shares, 3.0, "the first share")
        relayouts = engine._relayouts
        engine._request_relayout()                 # J's block starts again
        await wait_until(lambda: engine._relayouts > relayouts, 3.0,
                         "the relayout")
        await asyncio.sleep(0.05)
        engine.set_job(make_job(m, "K"))
        for _ in range(64):
            stub.allow.release()
        await wait_until(lambda: any(s[0] == "K" for s in shares), 3.0,
                         "a share of K")
    return shares


@pytest.mark.asyncio
async def test_a_job_change_after_a_relayout_emits_no_share_twice():
    """The respawned searcher mines J's extranonce2 0 again; its call is
    consumed after K replaced J. The port keeps the replaced job's share
    keys and emits J's share once; the reference forgets them at the job
    change and emits it twice."""
    first = ("J", b"\x00" * 4, 7)
    port = await _relayout_then_job_change(PORT)
    ref = await _relayout_then_job_change(REF)
    assert port.count(first) == 1 and len(port) == len(set(port))
    assert ref.count(first) == 2
