"""Keccak-512 (the original pre-SHA3 padding, as used by x11/Dash).

Lane-axis implementation: state words are ``[B]``-shaped uint64 numpy arrays,
so one call hashes a whole batch of candidate digests. The permutation is
Keccak-f[1600]; the only difference from hashlib's sha3_512 is the multi-rate
padding byte (0x01 here vs SHA3's 0x06), which the tests exploit: running
this sponge with the 0x06 domain byte must reproduce hashlib.sha3_512
exactly, which validates the permutation, rate handling and byte order
against an independent oracle.

Reference parity: the reference only name-registers keccak-family algorithms
(internal/mining/algorithm_simple_impls.go:84-101); x11's keccak512 stage is
implemented here from the Keccak specification.
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

RC = np.array(
    [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
        0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
        0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
        0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
        0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
        0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
        0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ],
    dtype=np.uint64,
)

# rho rotation offsets, indexed [x][y]
RHO = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

RATE_512 = 72  # bytes: 1600/8 - 2*512/8


def _rotl(x, n: int):
    n &= 63
    if n == 0:
        return x
    return (x << U64(n)) | (x >> U64(64 - n))


def keccak_f1600(A: list) -> list:
    """Keccak-f[1600] over a 5x5 list (index [x + 5*y]) of uint64 lanes."""
    for rnd in range(24):
        # theta
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        A = [A[x + 5 * y] ^ D[x] for y in range(5) for x in range(5)]
        # rho + pi: B[y, 2x+3y] = rot(A[x,y], r[x,y])
        B = [None] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(A[x + 5 * y], RHO[x][y])
        # chi
        A = [
            B[x + 5 * y] ^ ((~B[(x + 1) % 5 + 5 * y]) & B[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        # iota
        A[0] = A[0] ^ U64(RC[rnd])
    return A


def _absorb(data_words: np.ndarray, n_bytes: int, domain: int,
            rate_bytes: int = RATE_512) -> list:
    """Sponge absorb of a fixed-size message across lanes.

    ``data_words``: uint64 array ``[B, ceil(n_bytes/8)]`` — little-endian
    64-bit words of the message (trailing partial word zero-padded).
    ``domain``: padding domain byte (0x01 = original Keccak, 0x06 = SHA3).
    ``rate_bytes``: sponge rate (72 = keccak-512, 136 = keccak-256).
    Returns the 25-word state after absorbing all padded blocks.
    """
    B = data_words.shape[0]
    RATE = rate_bytes
    rate_words = RATE // 8
    # build padded message as word array
    n_blocks = n_bytes // RATE + 1
    total_words = n_blocks * rate_words
    padded = np.zeros((B, total_words), dtype=np.uint64)
    padded[:, :data_words.shape[1]] = data_words
    # domain byte at position n_bytes
    word_i, byte_i = divmod(n_bytes, 8)
    padded[:, word_i] |= U64(domain) << U64(8 * byte_i)
    # final bit of multi-rate padding: 0x80 at last byte of last block
    padded[:, total_words - 1] |= U64(0x80) << U64(56)

    state = [np.zeros(B, dtype=np.uint64) for _ in range(25)]
    for blk in range(n_blocks):
        for i in range(rate_words):
            state[i] = state[i] ^ padded[:, blk * rate_words + i]
        state = keccak_f1600(state)
    return state


def keccak512(data_words: np.ndarray, n_bytes: int, domain: int = 0x01) -> np.ndarray:
    """Keccak-512 of a fixed-size message across lanes.

    Input/output words are little-endian byte order. Returns ``[B, 8]``
    uint64 digest words.
    """
    state = _absorb(np.atleast_2d(data_words), n_bytes, domain)
    return np.stack(state[:8], axis=-1)


def keccak512_bytes(data: bytes, domain: int = 0x01) -> bytes:
    """Scalar convenience wrapper (oracle/tests)."""
    n = len(data)
    padded = data + b"\x00" * ((-n) % 8)
    words = np.frombuffer(padded, dtype="<u8").astype(np.uint64)[None, :]
    out = keccak512(words, n, domain)
    return out[0].astype("<u8").tobytes()


def keccak256_bytes(data: bytes, domain: int = 0x01) -> bytes:
    """Keccak-256 (rate 136) through the same certified sponge — the
    Ethereum hash (selectors, ethash seals)."""
    n = len(data)
    padded = data + b"\x00" * ((-n) % 8)
    words = (
        np.frombuffer(padded, dtype="<u8").astype(np.uint64)[None, :]
        if padded
        else np.zeros((1, 0), dtype=np.uint64)
    )
    state = _absorb(words, n, domain, rate_bytes=136)
    return np.stack(state[:4], axis=-1)[0].astype("<u8").tobytes()
