"""BMW-512 (Blue Midnight Wish, round-2 tweaked version — x11 stage 2).

Lane-axis implementation over uint64 numpy arrays, little-endian words.
Structure per the BMW specification: f0 (W quasi-group expansion of
M XOR H), f1 (expand1/expand2 to Q16..Q31 with the per-index K constants
and the rotating AddElement of message words), f2 (XL/XH folding), then the
spec's final compression with the CONST^final chaining vector, taking the
last 8 words as the digest.

Validation status: no external oracle in this offline environment; the
W-table sign pattern and shift tables below follow the submission's
reference code. Structural tests only (see skein.py note).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

# spec IV: word i = 0x8081828384858687 + i * 0x0808080808080808
IV512 = tuple(
    (0x8081828384858687 + i * 0x0808080808080808) & 0xFFFFFFFFFFFFFFFF
    for i in range(16)
)

FINAL512 = tuple(0xAAAAAAAAAAAAAAA0 + i for i in range(16))


def _rotl(x, n: int):
    return (x << U64(n)) | (x >> U64(64 - n))


def _s0(x):
    return (x >> U64(1)) ^ (x << U64(3)) ^ _rotl(x, 4) ^ _rotl(x, 37)


def _s1(x):
    return (x >> U64(1)) ^ (x << U64(2)) ^ _rotl(x, 13) ^ _rotl(x, 43)


def _s2(x):
    return (x >> U64(2)) ^ (x << U64(1)) ^ _rotl(x, 19) ^ _rotl(x, 53)


def _s3(x):
    return (x >> U64(2)) ^ (x << U64(2)) ^ _rotl(x, 28) ^ _rotl(x, 59)


def _s4(x):
    return (x >> U64(1)) ^ x


def _s5(x):
    return (x >> U64(2)) ^ x


_R = {1: 5, 2: 11, 3: 27, 4: 32, 5: 37, 6: 43, 7: 53}

# W[i] quasi-group expansion: (sign, index) terms over T[j] = M[j] ^ H[j]
_W_TERMS = (
    ((+1, 5), (-1, 7), (+1, 10), (+1, 13), (+1, 14)),
    ((+1, 6), (-1, 8), (+1, 11), (+1, 14), (-1, 15)),
    ((+1, 0), (+1, 7), (+1, 9), (-1, 12), (+1, 15)),
    ((+1, 0), (-1, 1), (+1, 8), (-1, 10), (+1, 13)),
    ((+1, 1), (+1, 2), (+1, 9), (-1, 11), (-1, 14)),
    ((+1, 3), (-1, 2), (+1, 10), (-1, 12), (+1, 15)),
    ((+1, 4), (-1, 0), (-1, 3), (-1, 11), (+1, 13)),
    ((+1, 1), (-1, 4), (-1, 5), (-1, 12), (-1, 14)),
    ((+1, 2), (-1, 5), (-1, 6), (+1, 13), (-1, 15)),
    ((+1, 0), (-1, 3), (+1, 6), (-1, 7), (+1, 14)),
    ((+1, 8), (-1, 1), (-1, 4), (-1, 7), (+1, 15)),
    ((+1, 8), (-1, 0), (-1, 2), (-1, 5), (+1, 9)),
    ((+1, 1), (+1, 3), (-1, 6), (-1, 9), (+1, 10)),
    ((+1, 2), (+1, 4), (+1, 7), (+1, 10), (+1, 11)),
    ((+1, 3), (-1, 5), (+1, 8), (-1, 11), (-1, 12)),
    ((+1, 12), (-1, 4), (-1, 6), (-1, 9), (+1, 13)),
)

_S_ORDER = (_s0, _s1, _s2, _s3, _s4)


def bmw512_compress(H: list, M: list) -> list:
    """One BMW-512 compression: H' = f2(f1(f0(M, H)), M, H)."""
    T = [M[i] ^ H[i] for i in range(16)]

    Q = []
    for i in range(16):
        # first term of every row is +1, so start from it (xor-0 copy works
        # for numpy lanes AND jax tracers)
        w = T[_W_TERMS[i][0][1]] ^ U64(0)
        for sign, j in _W_TERMS[i][1:]:
            w = w + T[j] if sign > 0 else w - T[j]
        Q.append(_S_ORDER[i % 5](w) + H[(i + 1) % 16])

    def add_element(i: int):
        k = U64(((i + 16) * 0x0555555555555555) & 0xFFFFFFFFFFFFFFFF)
        return (
            _rotl(M[i % 16], (i % 16) + 1)
            + _rotl(M[(i + 3) % 16], ((i + 3) % 16) + 1)
            - _rotl(M[(i + 10) % 16], ((i + 10) % 16) + 1)
            + k
        ) ^ H[(i + 7) % 16]

    # expand1 for Q16, Q17
    for i in range(2):
        acc = (
            _s1(Q[i]) + _s2(Q[i + 1]) + _s3(Q[i + 2]) + _s0(Q[i + 3])
            + _s1(Q[i + 4]) + _s2(Q[i + 5]) + _s3(Q[i + 6]) + _s0(Q[i + 7])
            + _s1(Q[i + 8]) + _s2(Q[i + 9]) + _s3(Q[i + 10]) + _s0(Q[i + 11])
            + _s1(Q[i + 12]) + _s2(Q[i + 13]) + _s3(Q[i + 14]) + _s0(Q[i + 15])
        )
        Q.append(acc + add_element(i))

    # expand2 for Q18..Q31
    for i in range(2, 16):
        acc = (
            Q[i] + _rotl(Q[i + 1], _R[1]) + Q[i + 2] + _rotl(Q[i + 3], _R[2])
            + Q[i + 4] + _rotl(Q[i + 5], _R[3]) + Q[i + 6] + _rotl(Q[i + 7], _R[4])
            + Q[i + 8] + _rotl(Q[i + 9], _R[5]) + Q[i + 10] + _rotl(Q[i + 11], _R[6])
            + Q[i + 12] + _rotl(Q[i + 13], _R[7]) + _s4(Q[i + 14]) + _s5(Q[i + 15])
        )
        Q.append(acc + add_element(i))

    XL = Q[16]
    for i in range(17, 24):
        XL = XL ^ Q[i]
    XH = XL
    for i in range(24, 32):
        XH = XH ^ Q[i]

    def shl(x, n):
        return x << U64(n)

    def shr(x, n):
        return x >> U64(n)

    out = [None] * 16
    out[0] = (shl(XH, 5) ^ shr(Q[16], 5) ^ M[0]) + (XL ^ Q[24] ^ Q[0])
    out[1] = (shr(XH, 7) ^ shl(Q[17], 8) ^ M[1]) + (XL ^ Q[25] ^ Q[1])
    out[2] = (shr(XH, 5) ^ shl(Q[18], 5) ^ M[2]) + (XL ^ Q[26] ^ Q[2])
    out[3] = (shr(XH, 1) ^ shl(Q[19], 5) ^ M[3]) + (XL ^ Q[27] ^ Q[3])
    out[4] = (shr(XH, 3) ^ Q[20] ^ M[4]) + (XL ^ Q[28] ^ Q[4])
    out[5] = (shl(XH, 6) ^ shr(Q[21], 6) ^ M[5]) + (XL ^ Q[29] ^ Q[5])
    out[6] = (shr(XH, 4) ^ shl(Q[22], 6) ^ M[6]) + (XL ^ Q[30] ^ Q[6])
    out[7] = (shr(XH, 11) ^ shl(Q[23], 2) ^ M[7]) + (XL ^ Q[31] ^ Q[7])
    out[8] = _rotl(out[4], 9) + (XH ^ Q[24] ^ M[8]) + (shl(XL, 8) ^ Q[23] ^ Q[8])
    out[9] = _rotl(out[5], 10) + (XH ^ Q[25] ^ M[9]) + (shr(XL, 6) ^ Q[16] ^ Q[9])
    out[10] = _rotl(out[6], 11) + (XH ^ Q[26] ^ M[10]) + (shl(XL, 6) ^ Q[17] ^ Q[10])
    out[11] = _rotl(out[7], 12) + (XH ^ Q[27] ^ M[11]) + (shl(XL, 4) ^ Q[18] ^ Q[11])
    out[12] = _rotl(out[0], 13) + (XH ^ Q[28] ^ M[12]) + (shr(XL, 3) ^ Q[19] ^ Q[12])
    out[13] = _rotl(out[1], 14) + (XH ^ Q[29] ^ M[13]) + (shr(XL, 4) ^ Q[20] ^ Q[13])
    out[14] = _rotl(out[2], 15) + (XH ^ Q[30] ^ M[14]) + (shr(XL, 7) ^ Q[21] ^ Q[14])
    out[15] = _rotl(out[3], 16) + (XH ^ Q[31] ^ M[15]) + (shr(XL, 2) ^ Q[22] ^ Q[15])
    return out


def bmw512(data_words: np.ndarray, n_bytes: int) -> np.ndarray:
    """BMW-512 across lanes. ``data_words``: uint64 ``[B, ceil(n/8)]``
    little-endian words. Returns ``[B, 8]`` LE digest words."""
    data_words = np.atleast_2d(data_words)
    B = data_words.shape[0]
    # message + 0x80 marker + 8-byte LE bitlen, padded to 128-byte blocks
    n_blocks = (n_bytes + 1 + 8 + 127) // 128
    padded = np.zeros((B, n_blocks * 16), dtype=np.uint64)
    padded[:, : data_words.shape[1]] = data_words
    word_i, byte_i = divmod(n_bytes, 8)
    padded[:, word_i] |= U64(0x80) << U64(8 * byte_i)
    padded[:, n_blocks * 16 - 1] = U64(n_bytes * 8)

    H = [np.full(B, U64(v), dtype=np.uint64) for v in IV512]
    for blk in range(n_blocks):
        M = [padded[:, blk * 16 + i] for i in range(16)]
        H = bmw512_compress(H, M)
    # final compression: message = H, chaining value = CONST^final
    Hf = [np.full(B, U64(v), dtype=np.uint64) for v in FINAL512]
    H = bmw512_compress(Hf, H)
    return np.stack(H[8:], axis=-1)


def bmw512_bytes(data: bytes) -> bytes:
    n = len(data)
    padded = data + b"\x00" * ((-n) % 8)
    words = np.frombuffer(padded, dtype="<u8").astype(np.uint64)[None, :]
    out = bmw512(words, n)
    return out[0].astype("<u8").tobytes()
