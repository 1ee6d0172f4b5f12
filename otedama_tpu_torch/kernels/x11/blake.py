"""BLAKE-512 (the SHA-3 finalist, 16 rounds — x11 stage 1).

Lane-axis implementation over uint64 numpy arrays. BLAKE-512 is the first
x11 stage and therefore the only one that sees the 80-byte block header;
every other stage hashes a 64-byte digest. Both fit in a single 128-byte
block, so the compression here is specialized to one-block messages (the
generic byte oracle in ``x11.__init__`` handles arbitrary sizes for tests).

Validated against the published BLAKE-512 known-answer vectors (the
single-zero-byte and 144-zero-byte digests from the BLAKE submission
package, reproduced in tests/test_x11.py).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

# first 64 hex digits of pi as 16 64-bit constants (shared with blowfish)
C512 = np.array(
    [
        0x243F6A8885A308D3, 0x13198A2E03707344, 0xA4093822299F31D0,
        0x082EFA98EC4E6C89, 0x452821E638D01377, 0xBE5466CF34E90C6C,
        0xC0AC29B7C97C50DD, 0x3F84D5B5B5470917, 0x9216D5D98979FB1B,
        0xD1310BA698DFB5AC, 0x2FFD72DBD01ADFB7, 0xB8E1AFED6A267E96,
        0xBA7C9045F12C7F99, 0x24A19947B3916CF7, 0x0801F2E2858EFC16,
        0x636920D871574E69,
    ],
    dtype=np.uint64,
)

IV512 = np.array(
    [
        0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
        0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
        0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
    ],
    dtype=np.uint64,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _rotr(x, n: int):
    return (x >> U64(n)) | (x << U64(64 - n))


def blake512_compress(h: list, m: list, t0: int, t1: int = 0) -> list:
    """One BLAKE-512 compression (16 rounds), salt = 0.

    ``h``: 8 uint64 lanes; ``m``: 16 uint64 lanes (big-endian words of the
    128-byte block); ``t0``/``t1``: bit counter. Returns the new 8-word h.
    """
    zero = h[0] ^ h[0]  # works for numpy lanes AND jax tracers
    t0w = U64(t0 & 0xFFFFFFFFFFFFFFFF)
    t1w = U64(t1 & 0xFFFFFFFFFFFFFFFF)
    v = list(h) + [
        zero + C512[0],
        zero + C512[1],
        zero + C512[2],
        zero + C512[3],
        zero + (t0w ^ C512[4]),
        zero + (t0w ^ C512[5]),
        zero + (t1w ^ C512[6]),
        zero + (t1w ^ C512[7]),
    ]

    def G(a, b, c, d, r, i):
        s = SIGMA[r % 10]
        v[a] = v[a] + v[b] + (m[s[2 * i]] ^ C512[s[2 * i + 1]])
        v[d] = _rotr(v[d] ^ v[a], 32)
        v[c] = v[c] + v[d]
        v[b] = _rotr(v[b] ^ v[c], 25)
        v[a] = v[a] + v[b] + (m[s[2 * i + 1]] ^ C512[s[2 * i]])
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = v[c] + v[d]
        v[b] = _rotr(v[b] ^ v[c], 11)

    for r in range(16):
        G(0, 4, 8, 12, r, 0)
        G(1, 5, 9, 13, r, 1)
        G(2, 6, 10, 14, r, 2)
        G(3, 7, 11, 15, r, 3)
        G(0, 5, 10, 15, r, 4)
        G(1, 6, 11, 12, r, 5)
        G(2, 7, 8, 13, r, 6)
        G(3, 4, 9, 14, r, 7)

    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake512(data_words: np.ndarray, n_bytes: int) -> np.ndarray:
    """BLAKE-512 of an ``n_bytes`` message across lanes.

    ``data_words``: uint64 ``[B, ceil(n_bytes/8)]`` — big-endian 64-bit words
    (trailing partial word zero-padded on the right/low side). Returns
    ``[B, 8]`` big-endian digest words.
    """
    data_words = np.atleast_2d(data_words)
    B = data_words.shape[0]
    n_blocks = n_bytes // 128 + (1 if (n_bytes % 128) <= 111 else 2)
    total_words = n_blocks * 16
    padded = np.zeros((B, total_words), dtype=np.uint64)
    padded[:, : data_words.shape[1]] = data_words
    # 0x80 marker bit after the message
    word_i, byte_i = divmod(n_bytes, 8)
    padded[:, word_i] |= U64(0x80) << U64(8 * (7 - byte_i))
    # 0x01 at byte 111 of the final block, then 128-bit big-endian bit length
    padded[:, total_words - 3] |= U64(0x01)
    bitlen = n_bytes * 8
    padded[:, total_words - 2] = U64(bitlen >> 64)
    padded[:, total_words - 1] = U64(bitlen & 0xFFFFFFFFFFFFFFFF)

    h = [np.full(B, IV512[i], dtype=np.uint64) for i in range(8)]
    for blk in range(n_blocks):
        m = [padded[:, blk * 16 + i] for i in range(16)]
        # counter: message bits processed up to and including this block;
        # a block containing no message bits uses t = 0
        t = min(bitlen, (blk + 1) * 1024)
        if t - blk * 1024 <= 0:
            t = 0
        h = blake512_compress(h, m, t & 0xFFFFFFFFFFFFFFFF, t >> 64)
    return np.stack(h, axis=-1)


def blake512_bytes(data: bytes) -> bytes:
    n = len(data)
    padded = data + b"\x00" * ((-n) % 8)
    words = np.frombuffer(padded, dtype=">u8").astype(np.uint64)[None, :]
    out = blake512(words, n)
    return out[0].astype(">u8").tobytes()
