"""Port parity, engine level: the drain of in-flight searches after a job
change, against the JAX package's ``MiningEngine``.

A stub backend holds the first job's three pipelined calls until the job
has changed; the second of them raises and the third holds a winner. The
reference's drain logs the failure and still emits the third call's
share, and so must the port's; both engines then go on mining the new
job. Shares are compared as (job, extranonce2, ntime, nonce, digest,
difficulty).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import queue
import threading
import time

import numpy as np
import pytest
import torch

from otedama_tpu.engine.engine import EngineConfig as RefEngineConfig
from otedama_tpu.engine.engine import MiningEngine as RefMiningEngine
from otedama_tpu.engine.types import Job as RefJob
from otedama_tpu.runtime import search as ref_search
from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.kernels import sha256_torch as st
from otedama_tpu_torch.runtime import search

BATCH = 64
DEPTH = 3           # three searches in flight: two are left to drain


def _job_fields(job_id: str, ntime: int) -> dict:
    return dict(job_id=job_id, prev_hash=bytes(32), coinb1=b"\x01" * 8,
                coinb2=b"\x02" * 8, merkle_branch=[], version=0x20000000,
                nbits=0x1D00FFFF, ntime=ntime, extranonce1=b"\xaa\xbb",
                extranonce2_size=4, share_target=(1 << 256) - 1,
                algorithm="sha256d")


class GatedStub:
    """The first ``DEPTH`` calls (the first job's pipeline) wait for
    ``gate``; of those the second raises and the third returns a winner at
    its base + 5. The next three calls (the second job) return a winner at
    their base; later calls return none. Winners carry their real digest."""

    name = "stub"

    def __init__(self, mod):
        self.mod = mod
        self.gate = threading.Event()
        self.lock = threading.Lock()
        self.calls = 0

    def search(self, jc, base, count):
        with self.lock:
            i = self.calls
            self.calls += 1
        if i < DEPTH:
            assert self.gate.wait(30.0), "the test never opened the gate"
        if i == 1:
            raise RuntimeError("injected: device call failed")
        nonces = {2: [base + 5], 3: [base], 4: [base], 5: [base]}.get(i, [])
        winners = [self.mod.Winner(n, jc.digest_for(n)) for n in nonces]
        return self.mod.SearchResult(winners, count, 0xFFFFFFFF)


async def _run(engine, stub: GatedStub, job_cls) -> set:
    found = []

    async def on_share(share):
        found.append(share)

    engine.on_share = on_share
    await engine.start()
    try:
        engine.set_job(job_cls(**_job_fields("first", 1_700_000_000)))
        deadline = time.monotonic() + 10.0
        while stub.calls < DEPTH:
            assert time.monotonic() < deadline, "the pipeline never filled"
            await asyncio.sleep(0.005)
        engine.set_job(job_cls(**_job_fields("second", 1_700_000_060)))
        stub.gate.set()
        # keeps mining: the second job's calls go on past its three winners
        # (a call is dispatched once the call DEPTH before it is consumed)
        while stub.calls < 2 * DEPTH + 4:
            assert time.monotonic() < deadline, f"{stub.calls} calls"
            await asyncio.sleep(0.005)
    finally:
        await engine.stop()
    return {(s.job_id, s.extranonce2, s.ntime, s.nonce_word, s.digest,
             s.difficulty) for s in found}


@pytest.mark.asyncio
async def test_a_failed_call_in_the_drain_keeps_the_winners_behind_it():
    port_stub, ref_stub = GatedStub(search), GatedStub(ref_search)
    port = MiningEngine({"stub": port_stub}, config=EngineConfig(
        batch_size=BATCH, auto_batch=False, pipeline_depth=DEPTH,
        searcher_restart_backoff=0.02))
    ref = RefMiningEngine({"stub": ref_stub}, config=RefEngineConfig(
        batch_size=BATCH, auto_batch=False, pipeline_depth=DEPTH,
        searcher_restart_backoff=0.02))
    got = await _run(port, port_stub, Job)
    want = await _run(ref, ref_stub, RefJob)
    en2 = b"\x00" * 4
    assert ("first", en2, 1_700_000_000, 2 * BATCH + 5) in {s[:4] for s in want}
    assert got == want
    assert sorted((s[0], s[3]) for s in got) == [
        ("first", 2 * BATCH + 5), ("second", 0), ("second", BATCH),
        ("second", 2 * BATCH)]
    # the drain crashed neither engine's searcher, and the port lost none
    # of its hashes
    assert port.supervisors["stub"].searcher_restarts == 0
    assert (port.supervisors["stub"].searcher_restarts
            == ref.supervisors["stub"].searcher_restarts)
    assert port.stats.hashes >= 6 * BATCH



class SerialStub:
    """One device: calls run one at a time, each taking ``CALL_S``, with
    no winner."""

    name = "stub"

    def __init__(self, mod):
        self.mod = mod
        self.lock = threading.Lock()
        self.calls = 0

    def search(self, jc, base, count):
        with self.lock:
            self.calls += 1
            time.sleep(CALL_S)
        return self.mod.SearchResult([], count, 0xFFFFFFFF)


CALL_S = 0.05
ROLL_BATCH = 1 << 31        # two calls an extranonce2 space


async def _peak_rate(engine, stub, job_cls, engine_mod, stats_cls,
                     monkeypatch) -> float:
    """The highest hashrate the engine's device EMA took while each
    extranonce2 roll's host hop took 0.2 s (a busy default executor)."""
    peak = [0.0]
    record = stats_cls.record_batch
    hop = engine_mod._job_constants_batch

    def traced(self, hashes, seconds, alpha=0.3):
        record(self, hashes, seconds, alpha)
        peak[0] = max(peak[0], self.hashrate)

    def slow_hop(*args):
        time.sleep(0.2)
        return hop(*args)

    monkeypatch.setattr(stats_cls, "record_batch", traced)
    monkeypatch.setattr(engine_mod, "_job_constants_batch", slow_hop)
    await engine.start()
    try:
        engine.set_job(job_cls(**_job_fields("first", 1_700_000_000)))
        deadline = time.monotonic() + 10.0
        while stub.calls < 8:
            assert time.monotonic() < deadline, f"{stub.calls} calls"
            await asyncio.sleep(0.005)
    finally:
        await engine.stop()
    return peak[0]


@pytest.mark.asyncio
async def test_a_slow_roll_does_not_spike_the_hashrate(monkeypatch):
    """ROADMAP Queue C 31: the device's hashrate is timed from one call's
    answer to the next. The reference restarts its clock at each
    extranonce2 roll, after the roll's host hop, so a call that finished
    during a slow hop samples its hashes over a few milliseconds: a rate
    many times the device's, which the failure detector then takes as
    the peak to hold the engine to."""
    from otedama_tpu.engine import engine as ref_engine_mod
    from otedama_tpu.engine.types import DeviceStats as RefDeviceStats
    from otedama_tpu_torch.engine import engine as engine_mod
    from otedama_tpu_torch.engine.types import DeviceStats

    nominal = ROLL_BATCH / CALL_S
    peaks = []
    for mod, emod, engine_cls, config_cls, job_cls, stats_cls in (
            (search, engine_mod, MiningEngine, EngineConfig, Job,
             DeviceStats),
            (ref_search, ref_engine_mod, RefMiningEngine, RefEngineConfig,
             RefJob, RefDeviceStats)):
        stub = SerialStub(mod)
        engine = engine_cls({"stub": stub}, config=config_cls(
            batch_size=ROLL_BATCH, auto_batch=False, pipeline_depth=2))
        peaks.append(await _peak_rate(engine, stub, job_cls, emod,
                                      stats_cls, monkeypatch))
    port, ref = peaks
    assert 0 < port <= 1.2 * nominal
    assert ref > 5 * nominal


class HeldStub:
    """Each call waits for its own release; the header's ntime field of
    every call is recorded in dispatch order."""

    name = "stub"

    def __init__(self):
        self.lock = threading.Lock()
        self.releases: list[threading.Event] = []
        self.ntimes: list[bytes] = []

    def search(self, jc, base, count):
        release = threading.Event()
        with self.lock:
            self.releases.append(release)
            self.ntimes.append(jc.header76[68:72])
        assert release.wait(30.0), "the test never released the call"
        return search.SearchResult([], count, 0xFFFFFFFF)


@pytest.mark.asyncio
async def test_a_new_job_dispatches_before_the_old_calls_drain():
    """ROADMAP Queue C 34: at a job change the port dispatches the new
    job's first call before it drains the old job's calls still in
    flight, so the card's stream never runs dry waiting for the event
    loop (the reference drains first). The drained call is still
    consumed, and nothing restarts."""
    stub = HeldStub()
    engine = MiningEngine({"stub": stub}, config=EngineConfig(
        batch_size=BATCH, auto_batch=False, pipeline_depth=2,
        searcher_restart_backoff=0.02))
    first, second = (_job_fields("first", 1_700_000_000),
                     _job_fields("second", 1_700_000_060))
    ntime_second = (1_700_000_060).to_bytes(4, "little")

    async def until(cond, what):
        deadline = time.monotonic() + 10.0
        while not cond():
            assert time.monotonic() < deadline, what
            await asyncio.sleep(0.005)

    await engine.start()
    try:
        engine.set_job(Job(**first))
        await until(lambda: len(stub.releases) == 2, "two calls in flight")
        stub.releases[0].set()
        await until(lambda: len(stub.releases) == 3, "the third call")
        engine.set_job(Job(**second))
        stub.releases[1].set()
        # the third call (the first job's) is still held, and the second
        # job's first call is already on its way
        await until(lambda: ntime_second in stub.ntimes,
                    "no call of the new job while the old one is held")
        assert not stub.releases[2].is_set()
        assert stub.ntimes[:3] == [(1_700_000_000).to_bytes(4, "little")] * 3
        for release in stub.releases:
            release.set()
        await until(lambda: engine.stats.hashes >= 4 * BATCH, "hashes")
    finally:
        for release in stub.releases:
            release.set()
        await engine.stop()
    assert engine.supervisors["stub"].searcher_restarts == 0


LAUNCH_S = 0.05
STREAM_BATCH = 256
# one share in 12 hashes: ~21 winners a 256-lane window, so a table of the
# default 16 slots overflows
WINNER_EVERY = 12
EASY_TARGET = (1 << 256) // WINNER_EVERY


class StreamStub(search._Sha256dBackend):
    """A card's stream in miniature: launches run one at a time in the
    order they were enqueued, each taking ``LAUNCH_S`` on the stream's
    thread; a call enqueues its group's launches and waits for their
    buffers, and an overflowing window's bisect enqueues its halves
    behind whatever the stream holds by then. The first job's winners are
    every ``WINNER_EVERY``-th nonce of its second group of windows (its
    first group has none: it is consumed at once); a winner's digest is
    zero. Each launch's end is logged with its job's ntime and the count
    word of its buffer."""

    name = "stub"

    def __init__(self):
        super().__init__("cpu", None)
        self.queue: queue.Queue = queue.Queue()
        self.done: list[tuple[float, bytes, int]] = []
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            buf, fut, ntime = self.queue.get()
            time.sleep(LAUNCH_S)
            self.done.append((time.monotonic(), ntime, int(buf[-3])))
            fut.set_result(buf)

    def _digest(self, jc, nonce_word):
        return bytes(32)

    def _launch_all(self, jc, windows, k=None):
        k = self.k if k is None else k
        futs = []
        for base, count in windows:
            wins = [w for w in range(base, base + count)
                    if jc.target and DEPTH * STREAM_BATCH <= w
                    < 2 * DEPTH * STREAM_BATCH and w % WINNER_EVERY == 0]
            buf = np.zeros(2 * k + 3, dtype=np.uint32)
            buf[k:2 * k] = 0xFFFFFFFF
            buf[:min(k, len(wins))] = wins[:k]
            buf[2 * k] = len(wins)
            fut = concurrent.futures.Future()
            self.queue.put((buf, fut, jc.header76[68:72]))
            futs.append(fut)
        return np.stack([f.result() for f in futs])


@pytest.mark.asyncio
async def test_an_overflowing_old_call_emits_before_the_new_jobs_first_group():
    """ROADMAP Queue C 35: at a job change the new job's first group is
    queued on the stream before the old job's last call is drained
    (Queue C 34). When that call's windows held more winners than a table
    of the default 16 slots, its bisect queued behind the new group and
    its shares came a whole group late. With the table sized from the
    job's target the old call's shares are emitted before the new job's
    first group has run."""
    stub = StreamStub()
    engine = MiningEngine({"stub": stub}, config=EngineConfig(
        batch_size=STREAM_BATCH, auto_batch=False, pipeline_depth=DEPTH,
        searcher_restart_backoff=0.02))
    old_ntime, new_ntime = 1_700_000_000, 1_700_000_060
    first = dict(_job_fields("first", old_ntime), share_target=EASY_TARGET)
    second = dict(_job_fields("second", new_ntime), share_target=0)
    emitted: list[tuple[float, str]] = []

    async def on_share(share):
        emitted.append((time.monotonic(), share.job_id))

    engine.on_share = on_share

    async def until(cond, what):
        deadline = time.monotonic() + 20.0
        while not cond():
            assert time.monotonic() < deadline, what
            await asyncio.sleep(0.002)

    new_tag = new_ntime.to_bytes(4, "little")
    await engine.start()
    try:
        engine.set_job(Job(**first))
        # both groups of the old job on the stream, the first one running
        await until(lambda: stub.queue.qsize() >= DEPTH,
                    "the old job's groups never queued")
        engine.set_job(Job(**second))
        await until(lambda: sum(t == new_tag for _, t, _ in stub.done)
                    >= DEPTH, "the new job's first group never ran")
        new_group_done = [t for t, tag, _ in stub.done
                          if tag == new_tag][DEPTH - 1]
        await until(lambda: len([1 for _, job in emitted if job == "first"])
                    >= DEPTH * (STREAM_BATCH // WINNER_EVERY),
                    "the old job's shares")
    finally:
        await engine.stop()
    old_counts = [n for _, tag, n in stub.done if tag != new_tag]
    assert max(old_counts) > search.sc.K_WINNERS  # 16 slots would overflow
    old = [t for t, job in emitted if job == "first"]
    assert max(old) < new_group_done, (
        f"the old job's last share came {max(old) - new_group_done:.3f} s "
        "after the new job's first group had run")
    assert engine.supervisors["stub"].searcher_restarts == 0


class OverlapStub:
    """A device whose calls overlap, as ethash's light and full tiers do
    on two streams of one card: every call takes ``CALL_S`` on a thread of
    its own, so the two calls in flight answer microseconds apart; no
    winner."""

    name = "stub"

    def __init__(self):
        self.calls = 0

    def search(self, jc, base, count):
        self.calls += 1
        time.sleep(CALL_S)
        return search.SearchResult([], count, 0xFFFFFFFF)


@pytest.mark.asyncio
async def test_overlapping_calls_do_not_spike_the_hashrate(monkeypatch):
    """Two calls in flight that run side by side answer almost at once:
    the second's hashes over the gap between the answers alone would be a
    rate far above the device's, which the failure detector then takes as
    the peak to hold the engine to (and restarts it below a quarter of
    it). The sample's time is at least the call's own since its dispatch,
    shared among the calls in flight."""
    from otedama_tpu_torch.engine.types import DeviceStats

    stub = OverlapStub()
    engine = MiningEngine({"stub": stub}, config=EngineConfig(
        batch_size=ROLL_BATCH, auto_batch=False, pipeline_depth=2))
    peak = [0.0]
    record = DeviceStats.record_batch

    def traced(self, hashes, seconds, alpha=0.3):
        record(self, hashes, seconds, alpha)
        peak[0] = max(peak[0], self.hashrate)

    monkeypatch.setattr(DeviceStats, "record_batch", traced)
    await engine.start()
    try:
        engine.set_job(Job(**_job_fields("first", 1_700_000_000)))
        deadline = time.monotonic() + 10.0
        while stub.calls < 12:
            assert time.monotonic() < deadline, f"{stub.calls} calls"
            await asyncio.sleep(0.005)
    finally:
        await engine.stop()
    # two calls at a time, each CALL_S: the device's rate
    device_rate = 2 * ROLL_BATCH / CALL_S
    assert 0 < peak[0] <= 1.2 * device_rate
