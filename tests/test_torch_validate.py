"""Port parity, the validation slice: device share validation at the pool
ledger, the PyTorch package against the JAX package on the CPU.

- the plain verify kernel (``sha256_torch.sha256d_verify_step``, what the
  CUDA kernel B2 is held against on the card) equals
  ``sha256_jax.sha256d_verify_step`` word for word, the reference's own
  oracle for its Pallas verify kernel (``tests/test_validation.py``); the
  Pallas kernel itself is not run here: in interpret mode one tile takes
  minutes on a CPU;
- the plain scrypt verify equals ``scrypt_jax.scrypt_verify_step`` and
  hashlib;
- ``ValidationBackend(device="cpu")`` gives the reference backend's
  verdicts and counters on mixed sha256d + scrypt batches, also under each
  package's own fault injector;
- ``PoolManager.on_share_batch`` books what the reference books, also
  under an injected db fault.

Integer work throughout: every comparison is exact (tolerance 0).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otedama_tpu.db import connect_database as ref_connect_database
from otedama_tpu.kernels import scrypt_jax as scj
from otedama_tpu.kernels import sha256_jax as sj
from otedama_tpu.kernels import target as ref_tgt
from otedama_tpu.pool.blockchain import MockChainClient as RefMockChainClient
from otedama_tpu.pool.manager import PoolConfig as RefPoolConfig
from otedama_tpu.pool.manager import PoolManager as RefPoolManager
from otedama_tpu.pool.payouts import PayoutConfig as RefPayoutConfig
from otedama_tpu.pool.payouts import PayoutScheme as RefPayoutScheme
from otedama_tpu.runtime import validate as ref_validate
from otedama_tpu.stratum.server import AcceptedShare as RefAcceptedShare
from otedama_tpu.utils import faults as ref_faults
from otedama_tpu_torch.db import connect_database
from otedama_tpu_torch.kernels import scrypt_cuda as scc
from otedama_tpu_torch.kernels import scrypt_torch as sct
from otedama_tpu_torch.kernels import sha256_cuda as sc
from otedama_tpu_torch.kernels import sha256_torch as st
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.pool.blockchain import MockChainClient
from otedama_tpu_torch.pool.manager import PoolConfig, PoolManager
from otedama_tpu_torch.pool.payouts import PayoutConfig, PayoutScheme
from otedama_tpu_torch.runtime import validate
from otedama_tpu_torch.stratum.server import AcceptedShare
from otedama_tpu_torch.utils import faults, pow_host

M32 = 0xFFFFFFFF


def _headers(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, 80, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _value(header: bytes, algorithm: str) -> int:
    if algorithm == "scrypt":
        d = hashlib.scrypt(header, salt=header, n=1024, r=1, p=1, dklen=32)
    else:
        d = hashlib.sha256(hashlib.sha256(header).digest()).digest()
    return int.from_bytes(d, "little")


def _boundary_targets(headers, algorithm="sha256d") -> list[int]:
    """Each third share's target exactly at its digest value (passes), one
    below (fails), one above (passes)."""
    vals = [_value(h, algorithm) for h in headers]
    return [v if i % 3 == 0 else (v - 1 if i % 3 == 1 else v + 1)
            for i, v in enumerate(vals)]


def _arrays(headers, targets):
    words = st.headers_to_words(headers)
    limbs = np.stack([tgt.target_to_limbs(t) for t in targets])
    return words, limbs


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _u32(buf) -> np.ndarray:
    return np.asarray(buf.numpy() if torch.is_tensor(buf) else buf).view(np.uint32)


@pytest.fixture(scope="module")
def sha_batch():
    headers = _headers(37, seed=7)
    return headers, _boundary_targets(headers)


@pytest.fixture(scope="module")
def scrypt_batch():
    headers = _headers(6, seed=5)
    return headers, _boundary_targets(headers, "scrypt")


# -- the plain verify kernels against the reference ---------------------------


@pytest.mark.parametrize("case", ["boundary", "overflow", "padding"])
def test_plain_sha256d_verify_equals_reference(sha_batch, case):
    headers, targets = sha_batch
    words, limbs = _arrays(headers, targets)
    k, last = (4 if case == "overflow" else 16), 36
    if case == "padding":
        # rows past `last` with zero targets would all fail: they never count
        words = np.pad(words, ((0, 11), (0, 0)))
        limbs = np.pad(limbs, ((0, 11), (0, 0)))
    want = np.asarray(sj.sha256d_verify_step(
        jnp.asarray(words), jnp.asarray(limbs), jnp.uint32(last),
        n=words.shape[0], k=k))
    got = _u32(st.sha256d_verify_step(_t(words), _t(limbs), last, k=k))
    assert np.array_equal(got, want)
    fails = [i for i, t in enumerate(targets) if _value(headers[i], "sha256d") > t]
    assert int(got[2 * k]) == len(fails) == 12
    assert got[:min(k, 12)].tolist() == fails[:k]
    # the wrapper on CPU tensors is the plain version, counted by `count`
    wrapped = _u32(sc.sha256d_verify(_t(words), _t(limbs), 37, k=k))
    assert np.array_equal(wrapped, want)


def test_plain_sha256d_verify_empty_batch():
    """count = 0: no failures and the sentinel min, the buffer the
    reference pins for its Pallas kernel's empty batch."""
    want = [0] * 8 + [M32] * 8 + [0, 0, M32]
    for rows in (0, 5):
        words = np.zeros((rows, 20), np.uint32)
        limbs = np.zeros((rows, 8), np.uint32)
        assert _u32(sc.sha256d_verify(_t(words), _t(limbs), 0, k=8)).tolist() == want
        assert _u32(st.sha256d_verify_step(_t(words), _t(limbs), -1, k=8)).tolist() == want
    with pytest.raises(ValueError, match="count"):
        sc.sha256d_verify(_t(words), _t(limbs), 6, k=8)


def test_sha256d_verify_writes_into_a_kept_out_buffer(sha_batch):
    """``out=`` (the ledger's kept buffer) receives the same words the
    call returns, from a ``words20[off:]`` view as well."""
    headers, targets = sha_batch
    words, limbs = _arrays(headers, targets)
    w, t = _t(words), _t(limbs)
    for off in (0, 3):
        out = torch.full((2 * 8 + 3,), 7, dtype=torch.int32)
        got = sc.sha256d_verify(w[off:], t[off:], 37 - off, k=8, out=out)
        assert got is out
        want = sj.sha256d_verify_step(
            jnp.asarray(words[off:]), jnp.asarray(limbs[off:]),
            jnp.uint32(36 - off), n=37 - off, k=8)
        assert _u32(out).tolist() == np.asarray(want).tolist()


def test_verify_layout_takes_only_aligned_contiguous_int32_rows():
    """What the card's verify kernel reads in place: contiguous int32
    rows starting on a 16-byte boundary; a ``words20[off:]`` view is one
    (80-byte rows), a view one word into a buffer, a strided view and
    int64 are not."""
    words = torch.zeros((9, 20), dtype=torch.int32)
    limbs = torch.zeros((9, 8), dtype=torch.int32)
    sc.check_verify_layout(words, limbs)
    sc.check_verify_layout(words[3:], limbs[3:])
    flat = torch.zeros(20 * 8 + 4, dtype=torch.int32)
    assert flat.data_ptr() % 16 == 0
    for bad in ((flat[1:161].view(8, 20), limbs[:8]),
                (words[:4], limbs[::2][:4]),
                (words, limbs.long())):
        with pytest.raises(ValueError, match="16-byte boundary"):
            sc.check_verify_layout(*bad)


def test_plain_scrypt_verify_equals_reference_and_hashlib(scrypt_batch):
    headers, targets = scrypt_batch
    words, limbs = _arrays(headers, targets)
    # padded to 32 rows, the shape the reference backend compiles for a
    # batch of this size (one compile serves both tests)
    wp, lp = np.pad(words, ((0, 26), (0, 0))), np.pad(limbs, ((0, 26), (0, 0)))
    want = np.asarray(scj.scrypt_verify_step(
        jnp.asarray(wp), jnp.asarray(lp), jnp.uint32(5), n=32, k=16,
        rolled=True))
    got = _u32(scc.scrypt_verify(_t(wp), _t(lp), 6, k=16))
    assert np.array_equal(got, want)
    vals = [_value(h, "scrypt") for h in headers]
    assert got[:2].tolist() == [1, 4] and int(got[32]) == 2
    assert int(got[34]) == min(v >> 224 for v in vals)
    # per-lane header words through the plain scrypt = hashlib
    cols = (_t(words).long() & M32).unbind(1)
    d = torch.stack(sct.scrypt_1024_1_1(cols[:19], cols[19])).T.numpy()
    assert [d[i].astype(">u4").tobytes() for i in range(6)] == [
        hashlib.scrypt(h, salt=h, n=1024, r=1, p=1, dklen=32) for h in headers]


# -- the ValidationBackend against the reference's ----------------------------


def _checks(mod, headers, targets, algorithm):
    return [mod.ShareCheck(h, t, algorithm) for h, t in zip(headers, targets)]


_COUNTERS = ("validated_device", "validated_host", "device_batches",
             "host_batches", "crossover_batches", "device_errors",
             "overflows", "tripwire_checks", "tripwire_mismatches", "rejects")


def _run_both(batches, ref_inj=None, port_inj=None, **kwargs):
    """Run the same list of (algorithm, headers, targets) batch groups
    through both backends, each under its own package's fault injector."""
    ref = ref_validate.ValidationBackend(**kwargs)
    port = validate.ValidationBackend(device="cpu", **kwargs)
    out = []
    for backend, mod, fmod, inj in ((ref, ref_validate, ref_faults, ref_inj),
                                    (port, validate, faults, port_inj)):
        verdicts = []
        with fmod.active(inj or fmod.FaultInjector()):
            for groups in batches:
                checks = [c for algo, hs, ts in groups
                          for c in _checks(mod, hs, ts, algo)]
                verdicts.append(asyncio.run(backend.verify_batch(checks)))
        snap = backend.snapshot()
        out.append((verdicts, {k: snap[k] for k in _COUNTERS},
                    snap["best_hash_hi"]))
    return out


@pytest.fixture(scope="module")
def mixed_batches(sha_batch, scrypt_batch):
    sha_h, sha_t = sha_batch
    scr_h, scr_t = scrypt_batch
    single = _headers(3, seed=11)
    return [
        # one batch of three algorithm groups: sha256d and scrypt on the
        # device path, single sha256 (no device tier) on the host
        [("sha256d", sha_h, sha_t), ("scrypt", scr_h, scr_t),
         ("sha256", single, [M32 >> 1 << 224] * 3)],
        # under min_batch: the crossover to the host
        [("sha256d", sha_h[:3], sha_t[:3])],
    ]


def test_validation_backend_equals_reference(mixed_batches):
    (rv, rs, rb), (pv, ps, pb) = _run_both(
        mixed_batches, min_batch=4, tripwire_rate=0.25, seed=3)
    assert pv == rv and ps == rs and pb == rb
    assert ps["device_batches"] == 2 and ps["crossover_batches"] == 1
    assert ps["tripwire_checks"] > 2 and ps["tripwire_mismatches"] == 0
    # the verdicts are hashlib's
    for groups, verdicts in zip(mixed_batches, pv):
        want = [(_value(h, algo) if algo != "sha256"
                 else int.from_bytes(hashlib.sha256(h).digest(), "little")) <= t
                for algo, hs, ts in groups for h, t in zip(hs, ts)]
        assert verdicts == want


@pytest.mark.parametrize("fault", ["error", "corrupt", "overflow"])
def test_validation_backend_rails_equal_reference(mixed_batches, fault):
    kwargs = dict(min_batch=4, tripwire_rate=0.25, seed=5)
    batches = mixed_batches
    if fault == "overflow":
        # 12 failures past k = 2
        batches, kwargs["k"] = [mixed_batches[0][:1]], 2
    injs = []
    for fmod in (ref_faults, faults):
        inj = fmod.FaultInjector(seed=9)
        if fault == "error":
            inj.error("validation.verify:sha256d", once=True)
        elif fault == "corrupt":
            inj.corrupt("validation.verify:sha256d", once=True)
        injs.append(inj)
    (rv, rs, rb), (pv, ps, pb) = _run_both(batches, *injs, **kwargs)
    assert pv == rv
    if fault == "overflow":
        # the reference re-verifies the whole group on the host; the port
        # settles it on the device with a table of 12 slots, then runs the
        # tripwire as for any device batch
        assert rs["overflows"] == ps["overflows"] == 1
        assert rs["rejects"] == ps["rejects"] == 12
        assert (rs["host_batches"], rs["validated_host"]) == (1, 37)
        assert (ps["device_batches"], ps["validated_device"]) == (1, 37)
        assert ps["host_batches"] == ps["validated_host"] == 0
        assert ps["tripwire_checks"] >= 1 and ps["tripwire_mismatches"] == 0
        assert pb == min(_value(h, "sha256d") >> 224 for h in batches[0][0][1])
        return
    assert ps == rs and pb == rb
    expect = {"error": "device_errors", "corrupt": "tripwire_mismatches"}[fault]
    assert ps[expect] == 1
    # the quarantine sends the scrypt group to the host as well
    assert ps["device_batches"] == 0 and ps["validated_device"] == 0


def test_validation_backend_raises_on_a_kernel_fault(sha_batch, monkeypatch):
    """Only the injected fault takes the host rail: a failed launch, or a
    wrong verdict that the tripwire finds, raises out of verify_batch."""
    headers, targets = sha_batch
    checks = _checks(validate, headers, targets, "sha256d")
    backend = validate.ValidationBackend(device="cpu", min_batch=4,
                                         tripwire_rate=1.0)

    def refuses(*args, **kwargs):
        raise RuntimeError("sha256d_verify launch failed: CUDA error 700")

    monkeypatch.setattr(sc, "sha256d_verify", refuses)
    with pytest.raises(RuntimeError, match="launch failed"):
        asyncio.run(backend.verify_batch(checks))
    plain = st.sha256d_verify_step

    def says_all_pass(words20, limbs, count, *, k, stream=None):
        buf = plain(words20, limbs, count - 1, k=k).clone()
        buf[:k], buf[k:2 * k], buf[2 * k] = 0, -1, 0
        return buf

    monkeypatch.setattr(sc, "sha256d_verify", says_all_pass)
    with pytest.raises(RuntimeError, match="tripwire"):
        asyncio.run(backend.verify_batch(checks))
    snap = backend.snapshot()
    assert snap["tripwire_mismatches"] == 1 and snap["device_errors"] == 0
    assert snap["host_batches"] == snap["device_batches"] == 0
    assert snap["device_ok"]


def test_validation_backend_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        validate.ValidationBackend()
    host_only = validate.ValidationBackend(device=None)
    assert not host_only.device_ok()


def test_dispatches_do_not_wait_on_the_loops_default_executor(sha_batch):
    """ROADMAP Queue C 30: a device dispatch waits for its read-back on
    threads of its own. With the loop's default executor held by a long
    call (on the card: the engine's hops, starved while dispatches waited
    behind the search kernel), a batch on the device path still settles."""
    headers, targets = sha_batch
    backend = validate.ValidationBackend(min_batch=1, tripwire_rate=0.0,
                                         device="cpu")
    checks = [validate.ShareCheck(h, t) for h, t in zip(headers, targets)]

    async def run():
        loop = asyncio.get_running_loop()
        loop.set_default_executor(concurrent.futures.ThreadPoolExecutor(1))
        gate = threading.Event()
        held = loop.run_in_executor(None, gate.wait, 30.0)
        try:
            return await asyncio.wait_for(backend.verify_batch(checks), 20.0)
        finally:
            gate.set()
            await held

    assert asyncio.run(run()) == [i % 3 != 1 for i in range(len(headers))]
    assert backend.snapshot()["device_batches"] == 1


def test_port_refuses_what_it_does_not_carry_yet():
    # x11 is carried since ROADMAP A9 (the host chain, tests/test_torch_x11.py)
    # and ethash since A10 (tests/test_torch_ethash*.py); their live-network
    # aliases refuse while the chains are uncertified
    with pytest.raises(ValueError, match="not certified canonical"):
        pow_host.pow_digest(bytes(80), "dash")
    with pytest.raises(ValueError, match="not certified canonical"):
        pow_host.pow_digest(bytes(80), "etchash")
    with pytest.raises(ValueError, match="no host PoW digest"):
        pow_host.pow_digest(bytes(80), "kawpow")


# -- the pool ledger ----------------------------------------------------------


def _accepted(cls, i: int, corrupt: bool = False):
    header = struct.pack(">I", i) * 20
    v = _value(header, "sha256d")
    # credited so the share meets its target, or (corrupt) so it cannot
    diff = ref_tgt.target_to_difficulty(v) * (4 if corrupt else 0.5)
    return cls(
        session_id=i, worker_user=f"w.{i % 2}", job_id="j1",
        difficulty=diff, actual_difficulty=diff,
        digest=v.to_bytes(32, "little"), header=header,
        extranonce2=struct.pack(">I", i), ntime=1_700_000_000, nonce_word=i,
        is_block=False, submitted_at=1_700_000_000.0,
    )


def _books(pm):
    return (pm.shares.count(), dict(pm.ledger_stats),
            [(w["name"], w["shares_valid"], w["balance"])
             for w in pm.workers.list()])


@pytest.mark.parametrize("db_fault", [False, True])
def test_pool_ledger_books_equal_reference(db_fault):
    results = []
    for mod, (Manager, Config, Payout, Scheme, Chain, connect, Share, fmod) in (
            (ref_validate, (RefPoolManager, RefPoolConfig, RefPayoutConfig,
                            RefPayoutScheme, RefMockChainClient,
                            ref_connect_database, RefAcceptedShare, ref_faults)),
            (validate, (PoolManager, PoolConfig, PayoutConfig, PayoutScheme,
                        MockChainClient, connect_database, AcceptedShare,
                        faults))):
        # PPS credits every share, so the balances are part of the books
        pm = Manager(connect(":memory:"), Chain(), config=Config(
            payout=Payout(scheme=Scheme.PPS, pps_rate_per_diff1=1e18)))
        backend = dict(min_batch=1, tripwire_rate=0.0)
        if mod is validate:
            backend["device"] = "cpu"
        pm.validator = mod.ValidationBackend(**backend)
        batch = [_accepted(Share, 1), _accepted(Share, 2, corrupt=True),
                 _accepted(Share, 3), _accepted(Share, 4)]
        inj = fmod.FaultInjector(seed=1)
        if db_fault:
            # the batch's 4th statement fails, then the first share's
            # replay: the savepoint replay rejects that share alone
            inj.error("db.execute", every_nth=4, max_fires=2)
        with fmod.active(inj):
            outcomes = asyncio.run(pm.on_share_batch(batch))
        results.append((outcomes, _books(pm),
                        pm.validator.snapshot()["rejects"]))
    assert results[0] == results[1]
    outcomes, (count, ledger, workers), rejects = results[1]
    assert outcomes[1] == ("err", "share failed validation") and rejects == 1
    assert count == (2 if db_fault else 3)
    assert [o[0] for o in outcomes] == (
        ["err", "err", "ok", "ok"] if db_fault else ["ok", "err", "ok", "ok"])
    assert ledger["shares_ok"] == count and all(w[2] > 0 for w in workers)
