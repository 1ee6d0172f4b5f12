"""CubeHash16/32-512 (x11 stage 8).

Lane-axis implementation over uint32 numpy arrays. CubeHash is fully
specified by five parameters — state of 32 uint32 words, block size b=32
bytes, r=16 rounds per block, i=f=10r=160 initial/final rounds — so the IV
is *derived* here by running the 160 initial rounds from the parameter
block (x[0]=h/8, x[1]=b, x[2]=r) rather than pasted from a table; the
structural test asserts the derivation is stable.

Padding: append 0x80, zero-fill to the 32-byte block boundary; finalize by
xoring 1 into x[31] and running 160 rounds. Words are little-endian.
"""

from __future__ import annotations

import functools

import numpy as np

U32 = np.uint32


def _rotl(x, n: int):
    return (x << U32(n)) | (x >> U32(32 - n))


def cubehash_rounds(x: list, n: int) -> list:
    """``n`` CubeHash rounds over 32 uint32 lanes (index = spec word order:
    bit 4 selects the half, bits 0-3 are (w,z,y,x) in spec terms)."""
    for _ in range(n):
        for i in range(16):
            x[i + 16] = x[i + 16] + x[i]
        for i in range(16):
            x[i] = _rotl(x[i], 7)
        for i in range(8):
            x[i], x[i ^ 8] = x[i ^ 8], x[i]
        for i in range(16):
            x[i] = x[i] ^ x[i + 16]
        for i in (16, 17, 20, 21, 24, 25, 28, 29):
            x[i], x[i ^ 2] = x[i ^ 2], x[i]
        for i in range(16):
            x[i + 16] = x[i + 16] + x[i]
        for i in range(16):
            x[i] = _rotl(x[i], 11)
        for i in (0, 1, 2, 3, 8, 9, 10, 11):
            x[i], x[i ^ 4] = x[i ^ 4], x[i]
        for i in range(16):
            x[i] = x[i] ^ x[i + 16]
        for i in (16, 18, 20, 22, 24, 26, 28, 30):
            x[i], x[i ^ 1] = x[i ^ 1], x[i]
    return x


@functools.lru_cache(maxsize=1)
def _iv512() -> np.ndarray:
    x = [np.zeros(1, dtype=np.uint32) for _ in range(32)]
    x[0] += U32(64)   # h/8
    x[1] += U32(32)   # b
    x[2] += U32(16)   # r
    x = cubehash_rounds(x, 160)
    return np.array([int(w[0]) for w in x], dtype=np.uint32)


def cubehash512(data_words: np.ndarray, n_bytes: int) -> np.ndarray:
    """CubeHash-512 across lanes.

    ``data_words``: uint32 ``[B, ceil(n_bytes/4)]`` little-endian words.
    Returns ``[B, 16]`` little-endian digest words.
    """
    data_words = np.atleast_2d(data_words)
    B = data_words.shape[0]
    n_blocks = n_bytes // 32 + 1
    padded = np.zeros((B, n_blocks * 8), dtype=np.uint32)
    padded[:, : data_words.shape[1]] = data_words
    word_i, byte_i = divmod(n_bytes, 4)
    padded[:, word_i] |= U32(0x80) << U32(8 * byte_i)

    iv = _iv512()
    x = [np.full(B, iv[i], dtype=np.uint32) for i in range(32)]
    for blk in range(n_blocks):
        for i in range(8):
            x[i] = x[i] ^ padded[:, blk * 8 + i]
        x = cubehash_rounds(x, 16)
    x[31] = x[31] ^ U32(1)
    x = cubehash_rounds(x, 160)
    return np.stack(x[:16], axis=-1)


def cubehash512_bytes(data: bytes) -> bytes:
    n = len(data)
    padded = data + b"\x00" * ((-n) % 4)
    words = np.frombuffer(padded, dtype="<u4").astype(np.uint32)[None, :]
    out = cubehash512(words, n)
    return out[0].astype("<u4").tobytes()
