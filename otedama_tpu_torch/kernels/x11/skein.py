"""Skein-512-512 (x11 stage 4): Threefish-512 in UBI chaining mode.

Lane-axis implementation over uint64 numpy arrays. The chain IV is the
published Skein-512-512 constant (Skein 1.3, as hardcoded by every fielded
implementation — the config-block UBI never runs at hashing time).

Tweak layout (128-bit as two uint64): t0 = byte position, t1 holds
type << 56 | first << 62 | final << 63. Words are little-endian.

Validation status: Threefish round structure, rotation table, permutation
and key schedule follow the final-round Skein spec; no external
known-answer oracle exists in this offline environment, so cross-network
parity is asserted by structural tests only (see tests/test_x11.py).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

# Threefish key-schedule parity constant, Skein 1.3 (v1.1's 0x5555... was
# tweaked to this value in the final-round submission x11 deployments use)
C240 = 0x1BD11BDAA9FC1A22

R512 = (
    (46, 36, 19, 37),
    (33, 27, 14, 42),
    (17, 49, 36, 39),
    (44, 9, 54, 56),
    (39, 30, 34, 24),
    (13, 50, 10, 17),
    (25, 29, 39, 43),
    (8, 35, 56, 22),
)

PERM = (2, 1, 4, 7, 6, 5, 0, 3)

T_CFG = 4
T_MSG = 48
T_OUT = 63

# published Skein-512-512 IV (Skein 1.3)
IV512 = (
    0x4903ADFF749C51CE, 0x0D95DE399746DF03, 0x8FD1934127C79BCE,
    0x9A255629FF352CB1, 0x5DB62599DF6CA7B0, 0xEABE394CA9D5C3F4,
    0x991112C71A75B523, 0xAE18A40B660FCC33,
)


def _rotl(x, n: int):
    return (x << U64(n)) | (x >> U64(64 - n))


def threefish512(key: list, tweak: tuple[int, int], block: list) -> list:
    """Threefish-512 encryption. ``key``/``block``: 8 uint64 lanes each;
    ``tweak``: two python ints. Returns ciphertext (8 lanes)."""
    zero = block[0] ^ block[0]  # works for numpy lanes AND jax tracers
    k = [kk for kk in key]
    k8 = zero + U64(C240)
    for kk in k:
        k8 = k8 ^ kk
    k = k + [k8]
    t = [
        U64(tweak[0] & 0xFFFFFFFFFFFFFFFF),
        U64(tweak[1] & 0xFFFFFFFFFFFFFFFF),
        U64((tweak[0] ^ tweak[1]) & 0xFFFFFFFFFFFFFFFF),
    ]

    def subkey(s: int) -> list:
        ks = [k[(s + i) % 9] for i in range(8)]
        ks[5] = ks[5] + t[s % 3]
        ks[6] = ks[6] + t[(s + 1) % 3]
        ks[7] = ks[7] + U64(s)
        return ks

    v = list(block)
    for d in range(72):
        if d % 4 == 0:
            ks = subkey(d // 4)
            v = [v[i] + ks[i] for i in range(8)]
        r = R512[d % 8]
        for j in range(4):
            a, b = v[2 * j], v[2 * j + 1]
            a = a + b
            b = _rotl(b, r[j]) ^ a
            v[2 * j], v[2 * j + 1] = a, b
        v = [v[PERM[i]] for i in range(8)]
    ks = subkey(18)
    return [v[i] + ks[i] for i in range(8)]


def ubi_block(
    G: list, block: list, position: int, type_code: int, first: bool, final: bool
) -> list:
    t1 = (type_code << 56) | (int(first) << 62) | (int(final) << 63)
    e = threefish512(G, (position, t1), block)
    return [e[i] ^ block[i] for i in range(8)]


def skein512(data_words: np.ndarray, n_bytes: int) -> np.ndarray:
    """Skein-512-512 across lanes.

    ``data_words``: uint64 ``[B, ceil(n_bytes/8)]`` little-endian words
    (partial trailing word zero-padded). Returns ``[B, 8]`` LE digest words.
    """
    data_words = np.atleast_2d(data_words)
    B = data_words.shape[0]
    n_blocks = max(1, (n_bytes + 63) // 64)
    padded = np.zeros((B, n_blocks * 8), dtype=np.uint64)
    padded[:, : data_words.shape[1]] = data_words

    G = [np.full(B, U64(iv), dtype=np.uint64) for iv in IV512]
    for blk in range(n_blocks):
        m = [padded[:, blk * 8 + i] for i in range(8)]
        position = min(n_bytes, (blk + 1) * 64)
        G = ubi_block(
            G, m, position, T_MSG, first=(blk == 0), final=(blk == n_blocks - 1)
        )
    zero = [np.zeros(B, dtype=np.uint64) for _ in range(8)]
    out = ubi_block(G, zero, 8, T_OUT, True, True)
    return np.stack(out, axis=-1)


def skein512_bytes(data: bytes) -> bytes:
    n = len(data)
    padded = data + b"\x00" * ((-n) % 8)
    words = np.frombuffer(padded, dtype="<u8").astype(np.uint64)[None, :]
    out = skein512(words, n)
    return out[0].astype("<u8").tobytes()
