"""The run-time modulus of kernels B7a and B7b light (``csrc/ethash.cu``
``fastmod``, its magic number made by the C entry points' ``magic_of``):
this file's model of the two, step for step as the source writes them,
held exact against ``%``.

Divisors: each epoch's cache rows and DAG pages (epochs 0-3, 100 and a
seeded sample of 64 below 2048) and the edges 1, 2, 3, 2^31 - 1 and
2^32 - 1. Dividends: 0, 1, d - 1, d, d + 1, the multiples of d next to
2^32 and one each side of them, 2^32 - 1, and 4,096 seeded ones. Host
arithmetic only (no card, no device tier of the reference): well under
5 s on one core.
"""

from __future__ import annotations

import numpy as np
import pytest

from otedama_tpu_torch.kernels import ethash as eth

M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
SEED = 20261018


def magic_of(d: int) -> int:
    """``magic_of``: ``~0ull / d + 1`` in 64-bit arithmetic."""
    return (M64 // d + 1) & M64


def fastmod(a, magic: int, d: int):
    """``fastmod``: the low 64 bits of ``magic * a``, then the high word
    of that times ``d`` (a 96-bit product taken as two 64-bit ones).
    ``a`` a Python int, or uint64 numpy values below 2^32 (wrapping as
    the card's)."""
    if isinstance(a, np.ndarray):
        magic, d, m32 = np.uint64(magic), np.uint64(d), np.uint64(M32)
        low = magic * a
        t = (low & m32) * d
        return ((low >> np.uint64(32)) * d + (t >> np.uint64(32))) >> np.uint64(32)
    low = (magic * a) & M64
    t = (low & M32) * d
    return (((low >> 32) * d + (t >> 32)) & M64) >> 32


def _epoch_divisors() -> list[int]:
    epochs = [0, 1, 2, 3, 100] + sorted(
        int(e) for e in np.random.default_rng(SEED).choice(2048, 64,
                                                           replace=False))
    out = []
    for epoch in epochs:
        block = epoch * eth.EPOCH_LENGTH
        out += [eth.cache_size(block) // eth.HASH_BYTES,
                eth.dataset_size(block) // eth.MIX_BYTES]
    return out


EDGE_DIVISORS = [1, 2, 3, (1 << 31) - 1, M32]
DIVISORS = _epoch_divisors() + EDGE_DIVISORS


def _dividends(d: int) -> list[int]:
    top = M32 // d * d                    # the largest multiple of d < 2^32
    cand = [0, 1, d - 1, d, d + 1, M32, top - 1, top, top + 1,
            top - d - 1, top - d, top - d + 1]
    return sorted({a for a in cand if 0 <= a <= M32})


def test_epoch_divisors_cover_the_chain():
    assert len(DIVISORS) == 2 * 69 + len(EDGE_DIVISORS)
    # epoch 0's sizes (the card's phases 34-36 run them)
    assert DIVISORS[:2] == [262_139, 8_388_593]
    assert all(1 <= d <= M32 for d in DIVISORS)


@pytest.mark.parametrize("d", DIVISORS)
def test_fastmod_is_exact(d):
    magic = magic_of(d)
    # the edge dividends as Python ints
    for a in _dividends(d):
        assert fastmod(a, magic, d) == a % d, (a, d)
    # 4,096 seeded ones in uint64 arithmetic
    a = np.random.default_rng(SEED + d % 997).integers(
        0, 1 << 32, 4096, dtype=np.uint64)
    assert np.array_equal(fastmod(a, magic, d), a % np.uint64(d))
