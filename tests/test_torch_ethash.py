"""Port parity, the ethash slice (kernels and their plain versions): the
port's ``kernels/ethash.py`` and ``kernels/ethash_torch.py`` against the
JAX package's ``kernels/ethash.py`` on the CPU, inputs made from a seed
with numpy, every comparison exact (integer words).

- the epoch rules (sizes and seeds at epochs 0-3 and 100), the keccak
  sponges, the python cache chain at 61 rows (against the reference's
  python chain and its native generator) and the compiled generator's
  source (the reference's ``keccak.cc``, carried over);
- ``derive_items`` against ``calc_dataset_item`` and ``build_dataset``
  against ``build_dataset_device``, on the reference's native-built
  251-row cache carried across (``ethash_cuda.epoch_tensors``);
- ``winner_step`` (light and full) against ``hashimoto_winners_device``
  word for word at 64 lanes and k = 16: one winner, an overflow, a window
  past 2^32 whose count is short of its lanes (``verify_step``:
  ``test_torch_ethash_host.py``);
- the kernel wrappers on CPU tensors (the plain versions), the dense form
  against the host oracle, the card's paths raising without a card; the
  kernel source's constants.

The kernels themselves run only on the card (``chip_smoke.py`` phases
34-38). ``verify_step``, ``pow_host`` and the validator:
``test_torch_ethash_host.py``; the backends and their epoch lifecycle:
``test_torch_ethash_paths.py``; the solo application:
``test_torch_ethash_app.py``.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from otedama_tpu.kernels import ethash as ref
from otedama_tpu.utils import jaxcompat
from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.kernels import ethash_cuda, ethash_torch
from otedama_tpu_torch.runtime import search

REPO = Path(__file__).resolve().parents[1]
M32 = 0xFFFFFFFF
ROWS, PAGES = 251, 509
FULL = PAGES * eth.MIX_BYTES
LANES = 64


@pytest.fixture(scope="module")
def epoch():
    """The reference's native-built 251-row cache and its 509-page DAG
    (``build_dataset_device``), and both carried onto the CPU as the
    port's tensors."""
    cache = ref.make_cache(ROWS * ref.HASH_BYTES, ref.seed_hash(0))
    with jaxcompat.enable_x64():
        dag = np.asarray(ref.build_dataset_device(cache, FULL,
                                                  item_chunk=1 << 10))
    cache_t, pages = ethash_cuda.epoch_tensors(cache, "cpu", dag)
    return cache, dag, cache_t, pages


@pytest.mark.parametrize("n_epoch", [0, 1, 2, 3, 100])
def test_epoch_rules_match_reference(n_epoch):
    bn = n_epoch * eth.EPOCH_LENGTH + 17
    assert eth.cache_size(bn) == ref.cache_size(bn)
    assert eth.dataset_size(bn) == ref.dataset_size(bn)
    assert eth.seed_hash(bn) == ref.seed_hash(bn)
    if n_epoch == 0:
        assert (eth.cache_size(bn), eth.dataset_size(bn)) == \
            (16_776_896, 1_073_739_904)
    if n_epoch == 1:
        assert (eth.cache_size(bn), eth.dataset_size(bn)) == \
            (16_907_456, 1_082_130_304)


def test_keccak_matches_reference_and_sha3():
    rng = np.random.default_rng(7)
    for n in (0, 1, 31, 32, 40, 64, 71, 76, 96, 135):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        if n < 72:
            assert np.array_equal(eth.keccak512_words(data),
                                  ref.keccak512_words(data))
            sha3 = eth.keccak512_rows(np.frombuffer(data, np.uint8)[None],
                                      domain=0x06)
            assert eth._u8(sha3)[0].tobytes() == hashlib.sha3_512(data).digest()
        assert eth.keccak256(data) == ref.keccak256(data)
        sha3 = eth.keccak256_rows(np.frombuffer(data, np.uint8)[None],
                                  domain=0x06)
        assert eth._u8(sha3)[0].tobytes() == hashlib.sha3_256(data).digest()
    # the plain sponges on tensors: 40, 64 and 96 bytes
    for n in (40, 64, 96):
        rows = rng.integers(0, 256, (3, n), dtype=np.uint8)
        words = torch.from_numpy(rows.view("<u4").astype(np.int64))
        fn = ethash_torch.keccak512 if n < 72 else ethash_torch.keccak256
        got = fn(words, n).numpy().astype(np.uint32)
        want = [(ref.keccak512_words if n < 72 else
                 lambda d: np.frombuffer(ref.keccak256(d), "<u4"))(r.tobytes())
                for r in rows]
        assert np.array_equal(got, np.stack(want))


def test_python_cache_chain_matches_reference():
    seed = eth.seed_hash(0)
    got = eth.make_cache(61 * eth.HASH_BYTES, seed, device="cpu")
    assert np.array_equal(got, ref._python_make_cache(61, seed))
    assert np.array_equal(got, ref.make_cache(61 * ref.HASH_BYTES, seed))


def test_compiled_generator_is_the_references_and_raises_without_nvcc():
    """The port's generator is the reference's ``keccak.cc`` from its
    first include on (the sponge, f1600 and ``otedama_ethash_make_cache``);
    without the toolkit ``make_cache`` for the card raises and never runs
    the python chain."""
    ours = (REPO / "otedama_tpu_torch/kernels/csrc/ethash_cache.cc").read_text()
    theirs = (REPO / "otedama_tpu/native/src/keccak.cc").read_text()
    body = theirs[theirs.index("#include <cstdint>"):]
    assert ours.endswith(body)
    calls = []
    real = eth._python_make_cache
    eth._python_make_cache = lambda *a: calls.append(a)
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            eth.make_cache(61 * eth.HASH_BYTES, eth.seed_hash(0))
    finally:
        eth._python_make_cache = real
    assert calls == []


def test_derive_items_match_calc_dataset_item(epoch):
    cache, _, cache_t, _ = epoch
    n_items = FULL // eth.HASH_BYTES
    idx = [0, 1, 7, n_items - 1]
    got = ethash_torch.derive_items(cache_t, torch.tensor(idx))
    for row, i in zip(got.numpy().astype(np.uint32), idx):
        assert np.array_equal(row, ref.calc_dataset_item(cache, i))
        assert np.array_equal(row, eth.calc_dataset_item(cache, i))
    assert np.array_equal(eth.derive_items_np(cache, np.array(idx, np.uint32)),
                          got.numpy().astype(np.uint32))


def test_build_dataset_matches_reference(epoch):
    _, dag, cache_t, pages = epoch
    got = ethash_cuda.build_dag(cache_t, FULL)     # the CPU: plain version
    assert got.shape == (PAGES, 32)
    assert np.array_equal(got.numpy().astype(np.uint32).reshape(-1, 16), dag)
    assert np.array_equal(pages.numpy().view(np.uint32).reshape(-1, 16), dag)


def _limbs(v: int) -> np.ndarray:
    return np.array([(v >> (224 - 32 * j)) & M32 for j in range(8)],
                    dtype=np.uint32)


# (name, base, count, top target limb): the targets were picked from the
# window's results (seeded header hash below) for the case each names; the
# last window wraps 2^32 AND counts fewer lanes than it has
WINNER_CASES = [
    ("one winner", 1 << 20, LANES, 0x02000000),
    ("overflow", 77, LANES, 0x90000000),
    ("past 2^32, count short of the lanes", (1 << 32) - 20, 41, 0x12000000),
]


@pytest.mark.parametrize("name,base,count,top", WINNER_CASES,
                         ids=[c[0] for c in WINNER_CASES])
def test_winner_step_matches_reference(epoch, name, base, count, top):
    cache, dag, cache_t, pages = epoch
    hh = np.random.default_rng(13).integers(0, 256, 32, dtype=np.uint8).tobytes()
    limbs = _limbs((top << 224) | ((1 << 224) - 1))
    nonces = (base + np.arange(LANES, dtype=np.uint64)) & M32
    want = ref.hashimoto_winners_device(FULL, cache, hh, nonces, limbs,
                                        count, 16)
    light = ethash_torch.winner_step(FULL, cache_t, hh, base, LANES, limbs,
                                     count, 16)
    full = ethash_torch.winner_step(FULL, pages, hh, base, LANES, limbs,
                                    count, 16, full=True)
    assert light.numpy().view(np.uint32).tolist() == want.tolist()
    assert full.numpy().view(np.uint32).tolist() == want.tolist()
    n = int(want[32])
    assert {"one winner": n == 1, "overflow": n > 16,
            "past 2^32, count short of the lanes": 0 < n <= 16}[name], \
        want.tolist()
    if base + count > 1 << 32:
        # winners on both sides of the wrap
        assert {int(o) < 20 for o in want[:n]} == {True, False}
    if name == "one winner":
        want_full = ref.hashimoto_winners_device(
            FULL, dag, hh, nonces, limbs, count, 16, full=True)
        assert want_full.tolist() == want.tolist()


def test_kernel_wrappers_run_the_plain_versions_on_cpu(epoch):
    cache, _, cache_t, pages = epoch
    hh = bytes(range(32))
    limbs = _limbs(1 << 250)
    before = (ethash_cuda.search_full_launches.value,
              ethash_cuda.dag_launches.value)
    got = ethash_cuda.ethash_search(FULL, pages, hh, 9, 49, limbs, batch=64,
                                    k=16, full=True)
    want = ethash_torch.winner_step(FULL, pages, hh, 9, 64, limbs, 50, 16,
                                    full=True)
    assert torch.equal(got, want)
    # the wrappers count launches on the card only
    assert (ethash_cuda.search_full_launches.value,
            ethash_cuda.dag_launches.value) == before
    assert ethash_cuda.pack_job(hh, (1 << 32) + 5, limbs).tolist() == \
        list(np.frombuffer(hh, "<u4")) + [5] + limbs.tolist()
    with pytest.raises(ValueError, match="batch"):
        ethash_cuda.ethash_search(FULL, pages, hh, 0, 0, limbs,
                                  batch=1 << 32, k=16, full=True)
    # the dense form (hashimoto_light_device / hashimoto_full_device): light
    # and full equal to the host oracle's pass
    nonces = [3, (1 << 40) + 9]
    want = eth.hashimoto_light_batch(FULL, cache, hh, nonces)
    for src, full in ((cache_t, False), (pages, True)):
        got = ethash_torch.hashimoto_dense(FULL, src, hh, nonces, full=full)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_card_paths_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less box")
    counters = (ethash_cuda.dag_launches, ethash_cuda.search_full_launches,
                ethash_cuda.search_light_launches, ethash_cuda.verify_launches)
    before = [c.value for c in counters]
    with pytest.raises(RuntimeError, match="nvcc"):
        ethash_cuda.load_library()
    with pytest.raises(RuntimeError, match="is_available"):
        search.EthashManagedBackend("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        search.EthashCudaBackend("cuda", cache_rows=ROWS, full_pages=PAGES)
    with pytest.raises(RuntimeError, match="is_available"):
        AlgorithmManager("auto").backend_for("ethash")
    assert [c.value for c in counters] == before


def test_kernel_source_constants():
    src = (REPO / "otedama_tpu_torch/kernels/csrc/ethash.cu").read_text()
    body = re.search(r"__constant__ uint64_t kRC\[24\] = \{(.*?)\};", src,
                     re.S).group(1)
    assert [int(v.rstrip("ul"), 16) for v in re.findall(r"0x[0-9A-Fa-f]+u?l*", body)] \
        == [int(v) for v in eth._RC]
    assert f"kThreads = {ethash_cuda.THREADS};" in src
    assert f"kJobWords = {ethash_cuda.JOB_WORDS};" in src
    assert f"kFnvPrime = {eth.FNV_PRIME:#010x}u;" in src
    assert f"kParents = {eth.DATASET_PARENTS};" in src
    assert f"kAccesses = {eth.ACCESSES};" in src
    # B7c runs the quad core: the one-thread core is gone, its count a
    # constant for the bounds
    assert ethash_cuda.ONE_THREAD_ITEM == 19_809
    for gone in (r"\bderive_item\b", r"\bhashimoto_light\(", r"\bpick\(",
                 r"\bitem1_count_kernel\b"):
        assert not re.search(gone, src), gone
    assert "item1" not in dict(ethash_cuda.COUNTED)


@pytest.mark.parametrize("kind", ["dag", "light", "verify"])
@pytest.mark.parametrize("quad_smaller", [True, False])
def test_bounds_take_the_smaller_item_core(kind, quad_smaller):
    """The bounds of B7a, B7b light and B7c count the smaller of the quad
    core's integer instructions and the one-thread core's (a constant),
    and say whose; B7c's hash is B7b light's."""
    def pipes(n):
        return {"total": n + 7, "alu": n - n // 3, "fma": n // 3, "shfl": 7}

    per_access = 10_000 if quad_smaller else 40_000
    item1 = ethash_cuda.ONE_THREAD_ITEM
    counts = {"seconds": 1.0, "full": pipes(14_000),
              "item": pipes(per_access), "light1": pipes(40_000),
              "light2": pipes(40_000 + per_access)}
    light = "light" if kind == "verify" else kind
    quad = {"dag": per_access,
            "light": 2 * (40_000 + (eth.ACCESSES - 1) * per_access)}[light]
    one = {"dag": item1,
           "light": 14_000 + 2 * eth.ACCESSES * item1}[light]
    assert (quad < one) == quad_smaller
    ops, whose = ethash_cuda.lane_ops(counts, kind)
    assert ops == min(quad, one)
    assert whose.startswith("the quad core's" if quad_smaller
                            else "the one-thread core's")
    terms = ethash_cuda.bound_ms(kind, 1 << 20, counts, sms=132,
                                 clock_mhz=1980.0, rows=ROWS, full_size=FULL)
    assert terms["operations"] == pytest.approx(
        (1 << 20) * ops / (132 * 128 * 1980e6) * 1e3, rel=1e-12)
