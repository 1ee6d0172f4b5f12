"""Luffa-512 (v2, 5-lane sponge — x11 stage 7).

Lane-axis implementation over uint32 numpy arrays. Five 256-bit sub-states
V0..V4 (8 words each, big-endian word order); per block: message injection
MI5 (xor-tree + word-ring doubling M2), then the five permutations Q0..Q4
(tweak rotation of the high half, 8 steps of bit-sliced SubCrumb + MixWord
+ per-step constants). Output: one blank round then fold the five states;
Luffa-512 emits two 256-bit halves (a second blank round for the second
half), big-endian words.

Validation status: round structure per the Luffa v2 spec; IV and step
constants from the published tables; no offline oracle. Structural tests.
"""

from __future__ import annotations

import numpy as np

U32 = np.uint32

IV = np.array(
    [
        [0x6D251E69, 0x44B051E0, 0x4EAA6FB4, 0xDBF78465,
         0x6E292011, 0x90152DF4, 0xEE058139, 0xDEF610BB],
        [0xC3B44B95, 0xD9D2F256, 0x70EEE9A0, 0xDE099FA3,
         0x5D9B0557, 0x8FC944B3, 0xCF1CCF0E, 0x746CD581],
        [0xF7EFC89D, 0x5DBA5781, 0x04016CE5, 0xAD659C05,
         0x0306194F, 0x666D1836, 0x24AA230A, 0x8B264AE7],
        [0x858075D5, 0x36D79CCE, 0xE571F7D7, 0x204B1F67,
         0x35870C6A, 0x57E9E923, 0x14BCB808, 0x7CDE72CE],
        [0x6C68E9BE, 0x5EC41E22, 0xC825B7C7, 0xAFFB4363,
         0xF5DF3999, 0x0FC688F1, 0xB07224CC, 0x03E86CEA],
    ],
    dtype=np.uint32,
)

# per-permutation step constants: CNS[j][step] = (c0 for x0, c4 for x4)
CNS = (
    ((0x303994A6, 0xE0337818), (0xC0E65299, 0x441BA90D),
     (0x6CC33A12, 0x7F34D442), (0xDC56983E, 0x9389217F),
     (0x1E00108F, 0xE5A8BCE6), (0x7800423D, 0x5274BAF4),
     (0x8F5B7882, 0x26889BA7), (0x96E1DB12, 0x9A226E9D)),
    ((0xB6DE10ED, 0x01685F3D), (0x70F47AAE, 0x05A17CF4),
     (0x0707A3D4, 0xBD09CACA), (0x1C1E8F51, 0xF4272B28),
     (0x707A3D45, 0x144AE5CC), (0xAEB28562, 0xFAA7AE2B),
     (0xBACA1589, 0x2E48F1C1), (0x40A46F3E, 0xB923C704)),
    ((0xFC20D9D2, 0xE25E72C1), (0x34552E25, 0xE623BB72),
     (0x7AD8818F, 0x5C58A4A4), (0x8438764A, 0x1E38E2E7),
     (0xBB6DE032, 0x78E38B9D), (0xEDB780C8, 0x27586719),
     (0xD9847356, 0x36EDA57F), (0xA2C78434, 0x703AACE7)),
    ((0xB213AFA5, 0xE028C9BF), (0xC84EBE95, 0x44756F91),
     (0x4E608A22, 0x7E8FCE32), (0x56D858FE, 0x956548BE),
     (0x343B138F, 0xFE191BE2), (0xD0EC4E3D, 0x3CB226E5),
     (0x2CEB4882, 0x5944A28E), (0xB3AD2208, 0xA1C4C355)),
    ((0xF0D2E9E3, 0x5090D577), (0xAC11D7FA, 0x2D1925AB),
     (0x1BCB66F2, 0xB46496AC), (0x6F2D9BC9, 0xD1925AB0),
     (0x78602649, 0x29131AB6), (0x8EDAE952, 0x0FC053C3),
     (0x3B6BA548, 0x3F014F0C), (0xEDAE9520, 0xFC053C31)),
)


def _rotl(x, n: int):
    return (x << U32(n)) | (x >> U32(32 - n))


def _m2(x: list) -> list:
    """Word-ring doubling: (x0..x7) -> (x7, x0^x7, x1, x2^x7, x3^x7, x4, x5, x6)."""
    t = x[7]
    return [t, x[0] ^ t, x[1], x[2] ^ t, x[3] ^ t, x[4], x[5], x[6]]


def _sub_crumb(a0, a1, a2, a3):
    tmp = a0
    a0 = a0 | a1
    a2 = a2 ^ a3
    a1 = ~a1
    a0 = a0 ^ a3
    a3 = a3 & tmp
    a1 = a1 ^ a3
    a3 = a3 ^ a2
    a2 = a2 & a0
    a0 = ~a0
    a2 = a2 ^ a1
    a1 = a1 | a3
    tmp = tmp ^ a1
    a3 = a3 ^ a2
    a2 = a2 & a1
    a1 = a1 ^ a0
    a0 = tmp
    return a0, a1, a2, a3


def _mix_word(u, v):
    v = v ^ u
    u = _rotl(u, 2) ^ v
    v = _rotl(v, 14) ^ u
    u = _rotl(u, 10) ^ v
    v = _rotl(v, 1)
    return u, v


def _q(x: list, j: int) -> list:
    """Permutation Q_j on one 8-word sub-state (lanes)."""
    # tweak: rotate words 4..7 left by j bits
    if j:
        for i in range(4, 8):
            x[i] = _rotl(x[i], j)
    for step in range(8):
        x[0], x[1], x[2], x[3] = _sub_crumb(x[0], x[1], x[2], x[3])
        x[5], x[6], x[7], x[4] = _sub_crumb(x[5], x[6], x[7], x[4])
        for i in range(4):
            x[i], x[i + 4] = _mix_word(x[i], x[i + 4])
        x[0] = x[0] ^ U32(CNS[j][step][0])
        x[4] = x[4] ^ U32(CNS[j][step][1])
    return x


def _mi5(V: list, M: list) -> list:
    """Luffa v2 message injection for w=5.

    Four phases (v2 added the two M2-ring mixes over v1's simple form —
    without them the five sub-states only interact through the xor-tree):
      1. xor-tree feedback: t = M2(⊕_j V_j); V_j ^= t
      2. ring mix up:   V_j = M2(V_j) ⊕ V_{j+1}  (parallel, from snapshot)
      3. ring mix down: V_j = M2(V_j) ⊕ V_{j-1}  (parallel, from snapshot)
      4. message chain: V_j ^= M2^j(M)
    Verified against the Luffa-512 ShortMsgKAT Len=0 digest (6e7de450...).
    """
    t = [V[0][i] ^ V[1][i] ^ V[2][i] ^ V[3][i] ^ V[4][i] for i in range(8)]
    t = _m2(t)
    V = [[V[j][i] ^ t[i] for i in range(8)] for j in range(5)]
    doubled = [_m2(v) for v in V]
    V = [
        [doubled[j][i] ^ V[(j + 1) % 5][i] for i in range(8)]
        for j in range(5)
    ]
    doubled = [_m2(v) for v in V]
    V = [
        [doubled[j][i] ^ V[(j - 1) % 5][i] for i in range(8)]
        for j in range(5)
    ]
    m = list(M)
    out = []
    for j in range(5):
        out.append([V[j][i] ^ m[i] for i in range(8)])
        m = _m2(m)
    return out


def luffa512(data_words: np.ndarray, n_bytes: int) -> np.ndarray:
    """Luffa-512 across lanes. ``data_words``: uint32 ``[B, ceil(n/4)]``
    big-endian words. Returns ``[B, 16]`` big-endian digest words."""
    data_words = np.atleast_2d(data_words)
    B = data_words.shape[0]
    # pad: 0x80 then zeros to a 32-byte boundary (always at least one bit)
    n_blocks = n_bytes // 32 + 1
    padded = np.zeros((B, n_blocks * 8), dtype=np.uint32)
    padded[:, : data_words.shape[1]] = data_words
    word_i, byte_i = divmod(n_bytes, 4)
    padded[:, word_i] |= U32(0x80) << U32(8 * (3 - byte_i))

    V = [[np.full(B, IV[j][i], dtype=np.uint32) for i in range(8)] for j in range(5)]
    for blk in range(n_blocks):
        M = [padded[:, blk * 8 + i] for i in range(8)]
        V = _mi5(V, M)
        V = [_q(V[j], j) for j in range(5)]

    zero = [np.zeros(B, dtype=np.uint32) for _ in range(8)]
    out = []
    for _ in range(2):  # two 256-bit output rounds
        V = _mi5(V, zero)
        V = [_q(V[j], j) for j in range(5)]
        for i in range(8):
            out.append(V[0][i] ^ V[1][i] ^ V[2][i] ^ V[3][i] ^ V[4][i])
    return np.stack(out, axis=-1)


def luffa512_bytes(data: bytes) -> bytes:
    n = len(data)
    padded = data + b"\x00" * ((-n) % 4)
    words = (
        np.frombuffer(padded, dtype=">u4").astype(np.uint32)[None, :]
        if padded
        else np.zeros((1, 0), dtype=np.uint32)
    )
    out = luffa512(words, n)
    return out[0].astype(">u4").tobytes()
