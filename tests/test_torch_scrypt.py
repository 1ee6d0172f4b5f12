"""Port parity, the scrypt slice: the PyTorch package's scrypt against the
JAX package's on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
every comparison is exact (integer arithmetic, tolerance 0):

- the plain BlockMix and BlockMix(X ^ V) against ``scrypt_jax`` and the
  Pallas kernels B3 and B4 (interpret mode);
- the plain ROMix, full V and ``half_v``, against the fused Pallas ROMix
  B5 (interpret mode);
- digests against hashlib, search buffers against
  ``scrypt_search_winners``, backends against ``ScryptXlaBackend`` and the
  hashlib oracle (a mid-chunk clamp, a winner-table overflow);
- the port's engine against the reference engine, the solo application
  and the CLI on scrypt, the engine's batch clamp, and the card paths,
  which raise here; the counts behind the kernels' bounds.

The jnp pipeline is compiled twice (``n=32`` with ``k=16`` and ``k=2``).
"""

from __future__ import annotations

import asyncio
import json
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otedama_tpu.engine.engine import EngineConfig as RefEngineConfig
from otedama_tpu.engine.engine import MiningEngine as RefMiningEngine
from otedama_tpu.engine.types import Job as RefJob
from otedama_tpu.kernels import scrypt_jax as ref_sj
from otedama_tpu.kernels import scrypt_pallas as ref_sp
from otedama_tpu.runtime import search as ref_search
from otedama_tpu_torch import cli
from otedama_tpu_torch.app import Application
from otedama_tpu_torch.config.schema import AppConfig, load_config
from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.kernels import scrypt_cuda as scc
from otedama_tpu_torch.kernels import scrypt_torch as st
from otedama_tpu_torch.pool.blockchain import MockChainClient
from otedama_tpu_torch.runtime import search
from otedama_tpu_torch.runtime.search import SearchResult
from otedama_tpu_torch.utils import pow_host

M32 = 0xFFFFFFFF
CHUNK = 32
ROLLED = ref_search._default_rolled()  # what ScryptXlaBackend compiles


def _bits(a: np.ndarray) -> torch.Tensor:
    """uint32 array -> int32 tensor of the same bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _header76(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, 76, dtype=np.uint8).tobytes()


def _values(h76: bytes, base: int, count: int) -> dict[int, int]:
    """hashlib scrypt of each nonce, as the little-endian integer."""
    return {(base + i) & M32: int.from_bytes(
        st.scrypt_digest_host(h76 + struct.pack(">I", (base + i) & M32)),
        "little") for i in range(count)}


# -- the kernels' plain versions ------------------------------------------------

def test_salsa_primitives_match_reference():
    x = _words(np.random.default_rng(1), 16, 5)
    ref_in = [jnp.asarray(x[i]) for i in range(16)]
    port_in = torch.from_numpy(x.astype(np.int64))
    for port_fn, ref_fn in ((st.salsa_double_round, ref_sj.salsa_double_round),
                            (st.salsa20_8, ref_sj.salsa20_8)):
        want = np.stack([np.asarray(w) for w in ref_fn(ref_in)])
        assert np.array_equal(port_fn(port_in).numpy().astype(np.uint32), want)


@pytest.mark.parametrize("with_v", [False, True])
def test_blockmix_matches_jnp_and_pallas_kernels(with_v):
    rng = np.random.default_rng(2 + with_v)
    X, V = _words(rng, 8, 32), _words(rng, 8, 32)   # lane-major, 8 lanes
    want = np.asarray(ref_sj.blockmix_salsa8_r1(jnp.asarray(X ^ V if with_v else X)))
    if with_v:
        pallas = ref_sp.blockmix_xor_pallas(jnp.asarray(X.T), jnp.asarray(V.T),
                                            interpret=True)
    else:
        pallas = ref_sp.blockmix_pallas(jnp.asarray(X.T), interpret=True)
    assert np.array_equal(np.asarray(pallas).T, want)
    Vt = _bits(V.T) if with_v else None
    assert np.array_equal(_u32(st.blockmix(_bits(X.T), Vt)).T, want)
    lane_major = X ^ V if with_v else X
    assert np.array_equal(st.blockmix_salsa8_r1(
        torch.from_numpy(lane_major.astype(np.int64))).numpy().astype(np.uint32), want)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    launches = scc.blockmix_launches.value + scc.blockmix_xor_launches.value
    calls = st.calls.value
    assert np.array_equal(_u32(scc.blockmix(_bits(X.T), Vt)).T, want)
    assert st.calls.value == calls + 1
    assert scc.blockmix_launches.value + scc.blockmix_xor_launches.value == launches


@pytest.mark.parametrize("half_v", [False, True])
def test_romix_matches_fused_pallas_kernel(half_v):
    Xt = _words(np.random.default_rng(4 + half_v), 32, 4)   # word-major, 4 lanes
    want = np.asarray(ref_sp.romix_fused_pallas(jnp.asarray(Xt), half_v=half_v,
                                                interpret=True))
    launches = scc.romix_launches.value
    got = scc.romix(_bits(Xt), half_v=half_v)    # CPU tensor: the plain version
    assert np.array_equal(_u32(got), want)
    assert scc.romix_launches.value == launches


def test_scrypt_digest_matches_hashlib():
    h76 = _header76(5)
    nonces = [0, 7, 0xDEADBEEF, M32]
    d = st.scrypt_1024_1_1(st.header_words19(h76), torch.tensor(nonces))
    got = torch.stack(d).T.numpy().astype(">u4")
    for lane, n in enumerate(nonces):
        header80 = h76 + struct.pack(">I", n)
        assert got[lane].tobytes() == ref_sj.scrypt_digest_host(header80)
        assert st.scrypt_digest_host(header80) == ref_sj.scrypt_digest_host(header80)
    assert st.header_words19(h76) == ref_sj.header_words19(h76)


# -- the search: buffers and backends --------------------------------------------

@pytest.fixture(scope="module")
def clamp_case():
    """23 in-range lanes of a 32-lane chunk; the target is the 3rd smallest
    in-range value, and lanes past the clamp would win too."""
    h76, base, count = _header76(7), 9, 23
    vals = _values(h76, base, CHUNK)
    in_range = {n: v for n, v in vals.items() if n < base + count}
    target = sorted(in_range.values())[2]
    assert any(v <= target for n, v in vals.items() if n >= base + count)
    return h76, base, count, target, in_range


def test_search_buffer_matches_scrypt_search_winners(clamp_case):
    h76, base, count, target, in_range = clamp_case
    jc = search.JobConstants.from_header_prefix(h76, target)
    h19 = st.header_words19(h76)
    want = np.asarray(ref_sj.scrypt_search_winners(
        jnp.asarray(np.array(h19, dtype=np.uint32)), jnp.uint32(base),
        jnp.asarray(jc.limbs), jnp.uint32(count - 1), n=CHUNK, k=16,
        rolled=ROLLED, blockmix="xla"))
    got = _u32(st.scrypt_search_buffer(h19, base, jc.limbs, count - 1,
                                       n=CHUNK, k=16))
    assert np.array_equal(got, want)
    assert got[:3].tolist() == sorted(n for n, v in in_range.items()
                                      if v <= target)
    # k = 2 overflows: only the count and the min top limb are defined,
    # and they do not depend on k
    small = _u32(st.scrypt_search_buffer(h19, base, jc.limbs, count - 1,
                                         n=CHUNK, k=2))
    assert (small[4], small[6]) == (want[32], want[34]) == \
        (3, min(in_range.values()) >> 224)
    # an empty window: no winner, no min
    empty = _u32(st.scrypt_search_buffer(h19, base, jc.limbs, M32, n=0, k=4))
    assert empty.tolist() == [0] * 4 + [M32] * 4 + [0, 0, M32]


def test_search_buffers_of_several_windows_match_hashlib():
    """Windows of one header share one ROMix call; each buffer is what
    hashlib's values give: across the 2^32 wrap, past k, and empty."""
    h76, k = _header76(11), 2
    windows = [(5, 6), (M32 - 2, 5), (77, 0)]
    vals = [_values(h76, base, count) for base, count in windows]
    target = sorted(vals[0].values())[2]     # the first window overflows k
    jc = search.JobConstants.from_header_prefix(h76, target)
    calls = st.calls.value
    got = _u32(st.scrypt_search_buffers(st.header_words19(h76), windows,
                                        jc.limbs, k=k))
    assert st.calls.value == calls + 1 and got.shape == (3, 2 * k + 3)
    assert got[0][2 * k] > k
    for (base, _), v, buf in zip(windows, vals, got):
        wins = [n for n in sorted(v, key=lambda n: (n - base) & M32)
                if v[n] <= target][:k]
        assert buf[2 * k] == sum(x <= target for x in v.values())
        assert buf[2 * k + 2] == min(v.values(), default=M32 << 224) >> 224
        assert buf[:k].tolist() == wins + [0] * (k - len(wins))
        assert buf[k:2 * k].tolist() == [v[n] >> 224 for n in wins] + \
            [M32] * (k - len(wins))


def test_bound_counts_of_the_scrypt_kernels():
    # V's traffic: the fill pass writes every row (the even ones with
    # half_v), and each of the 1,024 mix steps reads one
    assert scc.v_bytes_per_hash() == 256 * 1024
    assert scc.v_bytes_per_hash(half_v=True) == 192 * 1024
    assert scc.romix_ops(half_v=True) - scc.romix_ops() == \
        512 * scc.BLOCKMIX_OPS
    assert scc.ops_per_hash() == scc.romix_ops() + \
        scc.PBKDF2_COMPRESSIONS * scc.SHA256_COMPRESS_OPS


def test_torch_backend_matches_xla_backend_and_oracle(clamp_case):
    h76, base, count, target, in_range = clamp_case
    jc = search.JobConstants.from_header_prefix(h76, target)
    rjc = ref_search.JobConstants.from_header_prefix(h76, target)
    got = search.ScryptTorchBackend("cpu", chunk=CHUNK).search(jc, base, count)
    want = ref_search.ScryptXlaBackend(chunk=CHUNK).search(rjc, base, count)
    assert [(w.nonce_word, w.digest) for w in got.winners] == \
        [(w.nonce_word, w.digest) for w in want.winners]
    assert (got.hashes, got.best_hash_hi) == (want.hashes, want.best_hash_hi)
    expect = sorted(n for n, v in in_range.items() if v <= target)
    assert [w.nonce_word for w in got.winners] == expect
    # two launches of 16 and 7 lanes with k = 1: the first overflows, and
    # the backend bisects it with the same plain version; the result is
    # still the oracle's winners in nonce order
    tiny = search.ScryptTorchBackend("cpu", chunk=16, winner_depth=1)
    res = tiny.search(jc, base, count)
    assert [w.nonce_word for w in res.winners] == expect
    assert (res.hashes, res.best_hash_hi) == (count, min(in_range.values()) >> 224)
    python = search.ScryptPythonBackend().search(jc, base, count)
    assert [(w.nonce_word, w.digest) for w in python.winners] == \
        [(w.nonce_word, w.digest) for w in got.winners]
    assert python.best_hash_hi == got.best_hash_hi


# -- the slice as a whole -------------------------------------------------------

def _job_fields(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def rb(n):
        return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()

    return dict(
        job_id=f"scrypt-{seed}", prev_hash=rb(32), coinb1=rb(41), coinb2=rb(50),
        merkle_branch=[rb(32) for _ in range(2)], version=0x20000000,
        nbits=0x1E0FFFF0, ntime=int(time.time()), clean=True,
        extranonce1=rb(4), algorithm="scrypt",
        share_target=1 << 254,   # ~1 in 4 hashes is a share
    )


async def _shares(engine, job, hashes: int) -> set:
    found = []

    async def on_share(share):
        found.append(share)

    engine.on_share = on_share
    await engine.start()
    engine.set_job(job)
    deadline = time.monotonic() + 60.0
    while engine.stats.hashes < hashes:
        assert time.monotonic() < deadline, "engine made no progress"
        await asyncio.sleep(0.01)
    await engine.stop()
    return {
        (s.job_id, s.extranonce2, s.nonce_word, s.digest, s.difficulty)
        for s in found if s.extranonce2 == b"\x00" * 4 and s.nonce_word < hashes
    }


@pytest.mark.asyncio
async def test_engine_emits_the_reference_engines_scrypt_shares():
    f = _job_fields(8)
    port = MiningEngine(
        {"scrypt-torch": search.ScryptTorchBackend("cpu", chunk=CHUNK)},
        config=EngineConfig(algorithm="scrypt", batch_size=CHUNK,
                            auto_batch=False, pipeline_depth=1))
    ref = RefMiningEngine(
        {"scrypt-xla": ref_search.ScryptXlaBackend(chunk=CHUNK)},
        config=RefEngineConfig(algorithm="scrypt", batch_size=CHUNK,
                               auto_batch=False, pipeline_depth=1))
    got = await _shares(port, Job(**f), CHUNK)
    want = await _shares(ref, RefJob(**f), CHUNK)
    assert got == want and len(got) >= 3


@pytest.mark.asyncio
async def test_engine_clamps_batch_to_the_backends_max_batch():
    """A scrypt backend caps one search call (``max_batch``); the engine
    must clamp the configured batch down to it under auto_batch."""

    class SlowAlgoBackend:
        name = "slowalgo"
        max_batch = 512

        def __init__(self):
            self.batches: list[int] = []

        def search(self, jc, base, count):
            self.batches.append(count)
            return SearchResult([], count, M32)

    backend = SlowAlgoBackend()
    engine = MiningEngine({backend.name: backend},
                          config=EngineConfig(batch_size=1 << 22,
                                              pipeline_depth=1))
    assert engine.planned_batch(backend) == 512
    job = Job(job_id="clamp", prev_hash=bytes(32), coinb1=b"\x01",
              coinb2=b"\x02", merkle_branch=[], version=0x20000000,
              nbits=0x1D00FFFF, ntime=1700000000, share_target=1)
    await engine.start()
    engine.set_job(job)
    for _ in range(100):
        await asyncio.sleep(0.02)
        if backend.batches:
            break
    await engine.stop()
    assert backend.batches and backend.batches[0] == 512


@pytest.mark.asyncio
async def test_solo_application_mines_scrypt_shares_on_cpu(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("mining:\n  algorithm: scrypt\n  backend: python\n"
                    "  device: cpu\n  batch_size: 64\n  pipeline_depth: 1\n"
                    "work:\n  enabled: true\n  poll_seconds: 0.05\n")
    cfg = load_config(str(path))
    assert cfg.mining.algorithm == "scrypt"
    chain = MockChainClient(nbits=0x207FFFFF)   # half of all hashes win
    app = Application(cfg, chain=chain)
    submitted = []
    submit = chain.submit_block

    async def record(header):
        outcome = await submit(header)
        submitted.append((header, outcome))
        return outcome

    chain.submit_block = record
    await app.start()
    try:
        deadline = time.monotonic() + 60.0
        while len(submitted) < 3:
            assert time.monotonic() < deadline, app.snapshot()
            await asyncio.sleep(0.02)
    finally:
        await app.stop()
    target = 0x7FFFFF << (8 * (0x20 - 3))
    for header, outcome in submitted:
        # a scrypt block candidate: its scrypt digest meets the target; the
        # mock chain checks blocks by sha256d, as the reference's does
        assert int.from_bytes(st.scrypt_digest_host(header), "little") <= target
        assert outcome.accepted == (int.from_bytes(
            pow_host.sha256d(header), "little") <= target)
    snap = app.snapshot()["engine"]
    assert snap["algorithm"] == "scrypt" and snap["shares"]["found"] >= 3


def test_cli_and_manager_reach_the_scrypt_backends(capsys):
    assert cli.main(["benchmark", "-a", "scrypt", "-b", "python",
                     "--device", "cpu", "-n", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["benchmarks_h_per_s"]["scrypt/scrypt-python"] > 0
    mgr = AlgorithmManager("torch", device="cpu")
    assert isinstance(mgr.backend_for("litecoin"), search.ScryptTorchBackend)
    assert cli.build_parser().parse_args(["solo", "-a", "scrypt"]).algorithm == "scrypt"
    cfg = AppConfig()
    cfg.mining.algorithm = "scrypt"
    cfg.mining.backend = "torch"
    cfg.mining.device = "cpu"
    engine = Application(cfg)._build_engine()
    (backend,) = engine.backends.values()
    assert isinstance(backend, search.ScryptTorchBackend)
    assert engine.planned_batch(backend) == backend.max_batch == 4 * backend.chunk


def test_card_paths_raise_without_a_card():
    before = (scc.romix_launches.value, scc.search_launches.value,
              scc.blockmix_launches.value, scc.blockmix_xor_launches.value)
    with pytest.raises(RuntimeError, match="is_available"):
        search.ScryptCudaBackend("cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        search.ScryptCudaBackend("cpu")
    with pytest.raises(ValueError, match="tier"):
        search.ScryptCudaBackend("cuda", tier="pallas")
    with pytest.raises(RuntimeError, match="is_available"):
        AlgorithmManager("auto", device="cuda").backend_for("scrypt")
    with pytest.raises(Exception):
        scc.scrypt_search((0,) * 19, 0, np.zeros(8, np.uint32), 63, n=64,
                          device="cuda")
    with pytest.raises(ValueError, match="cuda or cpu"):
        scc.romix(torch.zeros(32, 4, dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError, match="nvcc"):
        scc.load_library()
    assert (scc.romix_launches.value, scc.search_launches.value,
            scc.blockmix_launches.value, scc.blockmix_xor_launches.value) == before


@pytest.mark.parametrize("lanes", [1, 7, 8, 9, 37, 4099, (1 << 18) - 5, 1 << 18])
def test_scratch_words_hold_v_exactly_at_ragged_lane_counts(lanes):
    # B5's V is [row][lane][32 words] whatever the lane count: a quad of
    # threads a lane needs no padding, so V is its 128 KiB a lane (64 KiB
    # with half_v) and the blockmix tier's [1024, 32, lanes] view takes it
    # whole; 2^18 lanes (the backends' chunk) need exactly 32 GiB
    words = scc.scratch_words(lanes)
    assert words * 4 == lanes * 128 << 10
    assert words == scc.SCRYPT_N * scc.ROW_WORDS * lanes
    assert scc.scratch_words(1 << 18) * 4 == 32 << 30


def test_kernel_ab_needs_two_trees_and_a_card(monkeypatch):
    # the script that times two trees of the package in turns refuses one
    # tree, and without a card exits 2 before it builds or times any tree
    from otedama_tpu_torch.kernels import card, kernel_ab
    with pytest.raises(SystemExit):
        kernel_ab.main(["."])
    monkeypatch.setattr(card, "smi", lambda query: "?")
    monkeypatch.setattr(kernel_ab, "run_child",
                        lambda *a: pytest.fail("a tree ran without a card"))
    assert kernel_ab.main([".", "."]) == 2