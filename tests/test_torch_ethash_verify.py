"""Port parity, ethash share validation (B7c, ``ethash_cuda.ethash_verify``)
and the empty call of both compactions, against the JAX package's device
functions on the CPU, on the reference's native-built 251-row cache
carried across (``ethash_cuda.epoch_tensors``), every comparison exact.

- the wrapper on CPU tensors (the plain version, ``verify_step``) against
  ``hashimoto_verify_device`` on 16 shares whose nonces cover the 64 bits
  (2^32 - 1, 2^32, 2^63, 2^64 - 1 and random ones), at an odd count (13)
  with the rows past it forged and k = 4 overflowed;
- ROADMAP Queue C 46: at count 0 the reference's verify reports row 0 and
  its search lane 0 (both clamp ``count - 1`` to 0 and keep no empty
  flag), where the port's buffers are empty, as the reference's own
  sha256d verify is (Queue C 3); at count 1 the two agree.

The card's kernel runs in ``chip_smoke.py`` phase 35 against the same plain
version, at these counts and the ledger's. Each reference call costs ~4 s
of eager JAX on one core (the first ~9 s), so every call here shares one
shape, 16 rows, and the reference runs three times: the verify at count
13, and the verify and the search at count 0. Its count-1 buffers are its
count-0 ones: both compact up to offset ``max(count - 1, 0)`` = 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from otedama_tpu.kernels import ethash as ref
from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.kernels import ethash_cuda
from otedama_tpu_torch.kernels import target as tgt

M32 = 0xFFFFFFFF
ROWS, PAGES = 251, 509
FULL = PAGES * eth.MIX_BYTES
N = 16
COUNT = 13
K = 4
# rows that fail: five inside the count (k = 4 overflows), the three past it
FORGED = (0, 2, 5, 8, 11, 13, 14, 15)


@pytest.fixture(scope="module")
def shares():
    """16 shares on the reference's cache: header hashes, 64-bit nonces,
    each one's target (its result, one below it where forged), and the
    verify's rows as CPU tensors."""
    cache = ref.make_cache(ROWS * ref.HASH_BYTES, ref.seed_hash(0))
    cache_t, _ = ethash_cuda.epoch_tensors(cache, "cpu")
    rng = np.random.default_rng(46)
    hhs = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    nonces = rng.integers(0, 1 << 64, N, dtype=np.uint64)
    nonces[:4] = [(1 << 64) - 1, 1 << 63, 1 << 32, M32]
    _, res = eth.hashimoto_light_batch(FULL, cache, hhs, nonces)
    vals = [int.from_bytes(r.tobytes(), "big") for r in res]
    limbs = np.stack([tgt.target_to_limbs(v - 1 if i in FORGED else v + i)
                      for i, v in enumerate(vals)])
    rows_h, rows_n = ethash_cuda.share_rows(hhs, nonces)
    parts = [torch.from_numpy(x.view(np.int32)) for x in (rows_h, rows_n, limbs)]
    return cache, cache_t, hhs, nonces, limbs, parts, vals


def test_verify_matches_reference_with_64_bit_nonces(shares):
    cache, cache_t, hhs, nonces, limbs, parts, vals = shares
    want = ref.hashimoto_verify_device(FULL, cache, hhs, nonces, limbs,
                                       COUNT, K)
    got = ethash_cuda.ethash_verify(FULL, cache_t, *parts, COUNT, k=K)
    assert got.numpy().view(np.uint32).tolist() == want.tolist()
    # overflowed: the first k failures in row order, all five counted, the
    # min top limb over the 13 rows only
    assert want[:K].tolist() == [0, 2, 5, 8] and want[2 * K] == 5
    assert want[2 * K + 2] == min(v >> 224 for v in vals[:COUNT])


BASE = (1 << 32) - 5     # the search's window wraps 2^32
ALL_ONES = np.full(8, M32, dtype=np.uint32)


@pytest.fixture(scope="module")
def reference_at_count_zero(shares):
    """The reference's verify and search buffers at count 0, each made at
    its first use."""
    cache, _, hhs, nonces, limbs = shares[:5]
    lanes = (BASE + np.arange(N, dtype=np.uint64)) & np.uint64(M32)
    calls = {
        "verify": lambda: ref.hashimoto_verify_device(
            FULL, cache, hhs, nonces, limbs, 0, K),
        "search": lambda: ref.hashimoto_winners_device(
            FULL, cache, bytes(hhs[0]), lanes, ALL_ONES, 0, K)}
    made: dict[str, list] = {}

    def get(kind: str) -> list:
        if kind not in made:
            made[kind] = calls[kind]().tolist()
        return made[kind]

    return get


def _port(kind: str, shares, count: int) -> list:
    _, cache_t, hhs, _, _, parts, _ = shares
    if kind == "verify":
        got = ethash_cuda.ethash_verify(FULL, cache_t, *parts, count, k=K)
    else:
        got = ethash_cuda.ethash_search(FULL, cache_t, bytes(hhs[0]), BASE,
                                        count - 1, ALL_ONES, batch=N, k=K,
                                        full=False)
    return got.numpy().view(np.uint32).tolist()


@pytest.mark.parametrize("count", [0, 1])
@pytest.mark.parametrize("kind", ["verify", "search"])
def test_count_zero_is_empty_in_the_port(shares, reference_at_count_zero,
                                         kind, count):
    """Queue C 46. Row 0 is forged and lane 0 meets the all-ones target,
    so the reference's clamp shows at count 0."""
    want = reference_at_count_zero(kind)
    got = _port(kind, shares, count)
    # the reference reports row or lane 0, whatever the count
    assert want[2 * K] == 1 and want[0] == 0
    if count == 0:
        assert got == [0] * K + [M32] * K + [0, 0, M32]
    else:
        assert got == want
