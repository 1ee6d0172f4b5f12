"""The plain PyTorch version of the x11 chain, its nonce search and its
share check.

Counterpart of ``otedama_tpu/kernels/x11/jnp_chain.py``
(``x11_digest_chain``, ``digest_limbs``, ``x11_winner_step``,
``x11_verify_step``), with the 80-byte header and the 64-byte digests'
padding fixed as there. It is what the CPU tests run and what the card's
kernel B6 (``csrc/x11.cu``, ``x11_cuda``) is held against; it repeats
the arithmetic in eager tensor ops and is no yardstick of speed.

Each stage is written the way B6 computes it, one lane's words at a time
across a lane axis, so that the tests that hold this module against the
JAX package's chain also check the kernel's design:

- the 64-byte value between stages is eight little-endian 64-bit words,
  and every stage converts at its boundary (byte-swaps for the
  big-endian stages);
- groestl runs on sixteen 64-bit columns through eight 256-entry tables
  (S-box and MixBytes together), the AES stages (shavite, echo) on 32-bit
  columns through the four AES T-tables;
- jh runs bitsliced: sixteen 64-bit words, the S-boxes and L as logic,
  the permutation as a bit swap of the odd words whose width cycles with
  the round (1, 2, 4, ..., 64 bits), with the round constants
  rearranged to match (``jh_tables``);
- simd's 256-point transform over Z_257 is an integer butterfly NTT; the
  final block's expanded words are a constant table (its input is the
  fixed length block);
- the shavite counter order is ``shavite.active_cnt_variant()`` of the
  port's own host tier, or an order given explicitly.

64-bit words travel as int64 tensors holding the bit pattern (constants
at or past 2^63 as their signed values): torch's CPU kernels refuse
shifts on ``uint64``. Right shifts are masked to be logical. 32-bit words
travel as int64 in ``[0, 2^32)`` with every add masked, as in
``sha256_torch``. There are no S-box modes: the gather-free bitplane
S-box of the TPU (``aes_bitslice``) gives the same bytes and has no
counterpart here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter
from otedama_tpu_torch.kernels.sha256_torch import compact_failures, \
    compact_winners, headers_to_words, le256
from otedama_tpu_torch.kernels.x11 import (
    blake,
    bmw,
    cubehash,
    groestl,
    jh,
    keccak,
    luffa,
    shavite,
    simd,
    skein,
)

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1

# calls of x11_search_buffer and x11_verify_step: chip_smoke shows that
# the card's main paths make none
calls = LaunchCounter()


def s64(v: int) -> int:
    """A 64-bit word's bit pattern as the int64 value torch holds."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def _shr(x, n: int):
    """Logical right shift of 64-bit words held as int64."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def _shl(x, n: int):
    return x << n


def _rotl(x, n: int):
    n &= 63
    return x if n == 0 else (x << n) | _shr(x, 64 - n)


def _rotl32(x, n: int):
    n &= 31
    return x if n == 0 else ((x << n) | (x >> (32 - n))) & M32


def _bswap64(x):
    out = torch.zeros_like(x)
    for i in range(8):
        out = out | (_shr(x, 8 * i) & 0xFF) << (8 * (7 - i))
    return out


def _bswap32(x):
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def _lo(x):
    return x & M32


def _hi(x):
    return _shr(x, 32)


def _join(lo, hi):
    return lo | (hi << 32)


def _to_u32_le(h):
    """Eight 64-bit words -> sixteen 32-bit words of the same bytes, LE."""
    out = []
    for w in h:
        out += [_lo(w), _hi(w)]
    return out


def _from_u32_le(w):
    return [_join(w[2 * i], w[2 * i + 1]) for i in range(8)]


# -- the tables B6 reads, derived from the port's host-tier modules -------------



@functools.lru_cache(maxsize=1)
def aes_table() -> np.ndarray:
    """AES T0 as little-endian 32-bit columns: T0[x] = (2S, S, S, 3S)
    bytes for S = sbox[x]; T1..T3 are its rotations by 8, 16, 24 bits."""
    sbox = groestl.aes_sbox().astype(np.uint64)
    gf = groestl._gf_tables()
    m2 = gf[2][groestl.aes_sbox()].astype(np.uint64)
    m3 = gf[3][groestl.aes_sbox()].astype(np.uint64)
    return (m2 | (sbox << 8) | (sbox << 16) | (m3 << 24)).astype(np.uint32)


@functools.lru_cache(maxsize=1)
def groestl_tables() -> np.ndarray:
    """``[8, 256]`` uint64: for an input byte x in row i, the 64-bit
    column (row r at bits 8r) of its MixBytes contributions,
    mul(MIX[(i - r) mod 8], sbox[x]); table i is table 0 rotated left by
    8i bits."""
    sbox = groestl.aes_sbox()
    gf = dict(groestl._gf_tables())
    gf[1] = np.arange(256, dtype=np.uint8)
    out = np.zeros((8, 256), dtype=np.uint64)
    for i in range(8):
        for r in range(8):
            mult = groestl._MIX[(i - r) % 8]
            out[i] |= gf[mult][sbox].astype(np.uint64) << np.uint64(8 * r)
    return out


@functools.lru_cache(maxsize=1)
def jh_tables() -> tuple[np.ndarray, np.ndarray]:
    """JH in the bitsliced form: the IV as sixteen big-endian 64-bit words
    (word 2j the high half of 128-bit word j) and the 42 round constants
    ``[42, 4]`` (even words' high and low halves, odd words' high and
    low halves). In this form a round keeps each element's four bits at
    one bit position of words (0, 2, 4, 6) or (1, 3, 5, 7); the spec's
    permutation P8 becomes a swap of the odd words' bits at distance
    2^(r mod 7), and the constants follow the element positions round by
    round (back to the spec's layout after 42 rounds)."""
    perm8 = jh._perm_indices(8)
    cbits = jh.round_constants()
    layout = [(e % 2, e // 2) for e in range(256)]
    consts = np.zeros((42, 4), dtype=np.uint64)
    for r in range(42):
        words = [0, 0]
        for e, (par, p) in enumerate(layout):
            if cbits[r][e]:
                words[par] |= 1 << (127 - p)
        consts[r] = [words[0] >> 64, words[0] & M64,
                     words[1] >> 64, words[1] & M64]
        layout = [(par, p ^ (1 << (r % 7)) if par else p)
                  for par, p in (layout[int(perm8[i])] for i in range(256))]
    assert layout == [(e % 2, e // 2) for e in range(256)]
    iv = np.frombuffer(jh._iv512().tobytes(), dtype=">u8").astype(np.uint64)
    return iv, consts


@functools.lru_cache(maxsize=1)
def simd_tables() -> dict:
    normal, final = simd._twist_tables()
    # the final block is the fixed length block (512 as 8 LE bytes): its
    # expanded words do not depend on the lane
    lb = np.zeros((1, 128), dtype=np.uint8)
    lb[0, :8] = np.frombuffer((512).to_bytes(8, "little"), dtype=np.uint8)
    w_final = simd._expand(lb, final=True)[0]
    omega_pow = np.array([pow(41, k, 257) for k in range(256)], dtype=np.int64)
    return {"twist": normal.astype(np.int64), "w_final": w_final,
            "omega_pow": omega_pow}


@functools.lru_cache(maxsize=1)
def cubehash_iv() -> np.ndarray:
    return cubehash._iv512().astype(np.uint32)


_TENSORS: dict = {}


def _t(name: str, device) -> torch.Tensor:
    """A table as an int64 tensor on ``device`` (cached)."""
    key = (name, str(device))
    t = _TENSORS.get(key)
    if t is None:
        if name == "aes":
            base = aes_table().astype(np.int64)
            rot = [((base << (8 * i)) | (base >> (32 - 8 * i))) & M32
                   for i in range(4)]
            arr = np.stack(rot)
        elif name == "groestl":
            arr = np.array([[s64(int(v)) for v in row]
                            for row in groestl_tables()], dtype=np.int64)
        elif name == "twist":
            arr = simd_tables()["twist"]
        elif name == "omega_pow":
            arr = simd_tables()["omega_pow"]
        elif name == "w_final":
            arr = simd_tables()["w_final"].astype(np.int64)
        else:
            raise KeyError(name)
        t = torch.as_tensor(arr, dtype=torch.int64, device=device)
        _TENSORS[key] = t
    return t


def _c(v: int, like):
    return torch.full_like(like, s64(v))


# -- stage 1: blake512 of the 80-byte header ----------------------------------

def blake512_80(hw):
    """``hw``: the header's ten big-endian 64-bit words (list of tensors).
    Returns the digest as eight little-endian 64-bit words."""
    z = hw[0] ^ hw[0]
    m = list(hw) + [z + s64(0x8000000000000000), z, z, z + 1, z, z + 640]
    c = [int(x) for x in blake.C512]
    v = [z + s64(int(x)) for x in blake.IV512] + [
        z + s64(c[0]), z + s64(c[1]), z + s64(c[2]), z + s64(c[3]),
        z + s64(640 ^ c[4]), z + s64(640 ^ c[5]), z + s64(c[6]), z + s64(c[7])]
    h0 = v[:8]

    def g(a, b, cc, d, r, i):
        s = blake.SIGMA[r % 10]
        v[a] = v[a] + v[b] + (m[s[2 * i]] ^ s64(c[s[2 * i + 1]]))
        v[d] = _rotl(v[d] ^ v[a], 32)
        v[cc] = v[cc] + v[d]
        v[b] = _rotl(v[b] ^ v[cc], 39)
        v[a] = v[a] + v[b] + (m[s[2 * i + 1]] ^ s64(c[s[2 * i]]))
        v[d] = _rotl(v[d] ^ v[a], 48)
        v[cc] = v[cc] + v[d]
        v[b] = _rotl(v[b] ^ v[cc], 53)

    for r in range(16):
        g(0, 4, 8, 12, r, 0)
        g(1, 5, 9, 13, r, 1)
        g(2, 6, 10, 14, r, 2)
        g(3, 7, 11, 15, r, 3)
        g(0, 5, 10, 15, r, 4)
        g(1, 6, 11, 12, r, 5)
        g(2, 7, 8, 13, r, 6)
        g(3, 4, 9, 14, r, 7)
    return [_bswap64(h0[i] ^ v[i] ^ v[i + 8]) for i in range(8)]


# -- stage 2: bmw512 -----------------------------------------------------------

def _bmw_compress(H, M):
    s_fns = (
        lambda x: _shr(x, 1) ^ _shl(x, 3) ^ _rotl(x, 4) ^ _rotl(x, 37),
        lambda x: _shr(x, 1) ^ _shl(x, 2) ^ _rotl(x, 13) ^ _rotl(x, 43),
        lambda x: _shr(x, 2) ^ _shl(x, 1) ^ _rotl(x, 19) ^ _rotl(x, 53),
        lambda x: _shr(x, 2) ^ _shl(x, 2) ^ _rotl(x, 28) ^ _rotl(x, 59),
        lambda x: _shr(x, 1) ^ x,
        lambda x: _shr(x, 2) ^ x,
    )
    T = [M[i] ^ H[i] for i in range(16)]
    Q = []
    for i in range(16):
        terms = bmw._W_TERMS[i]
        w = T[terms[0][1]]
        for sign, j in terms[1:]:
            w = w + T[j] if sign > 0 else w - T[j]
        Q.append(s_fns[i % 5](w) + H[(i + 1) % 16])

    def add_element(i):
        k = s64((i + 16) * 0x0555555555555555)
        return (_rotl(M[i % 16], i % 16 + 1)
                + _rotl(M[(i + 3) % 16], (i + 3) % 16 + 1)
                - _rotl(M[(i + 10) % 16], (i + 10) % 16 + 1)
                + k) ^ H[(i + 7) % 16]

    s0, s1, s2, s3, s4, s5 = s_fns
    for i in range(2):
        acc = Q[i] ^ Q[i]
        for j in range(16):
            acc = acc + (s1, s2, s3, s0)[j % 4](Q[i + j])
        Q.append(acc + add_element(i))
    r = bmw._R
    for i in range(2, 16):
        acc = (Q[i] + _rotl(Q[i + 1], r[1]) + Q[i + 2] + _rotl(Q[i + 3], r[2])
               + Q[i + 4] + _rotl(Q[i + 5], r[3]) + Q[i + 6]
               + _rotl(Q[i + 7], r[4]) + Q[i + 8] + _rotl(Q[i + 9], r[5])
               + Q[i + 10] + _rotl(Q[i + 11], r[6]) + Q[i + 12]
               + _rotl(Q[i + 13], r[7]) + s4(Q[i + 14]) + s5(Q[i + 15]))
        Q.append(acc + add_element(i))
    XL = Q[16]
    for i in range(17, 24):
        XL = XL ^ Q[i]
    XH = XL
    for i in range(24, 32):
        XH = XH ^ Q[i]
    o = [None] * 16
    o[0] = (_shl(XH, 5) ^ _shr(Q[16], 5) ^ M[0]) + (XL ^ Q[24] ^ Q[0])
    o[1] = (_shr(XH, 7) ^ _shl(Q[17], 8) ^ M[1]) + (XL ^ Q[25] ^ Q[1])
    o[2] = (_shr(XH, 5) ^ _shl(Q[18], 5) ^ M[2]) + (XL ^ Q[26] ^ Q[2])
    o[3] = (_shr(XH, 1) ^ _shl(Q[19], 5) ^ M[3]) + (XL ^ Q[27] ^ Q[3])
    o[4] = (_shr(XH, 3) ^ Q[20] ^ M[4]) + (XL ^ Q[28] ^ Q[4])
    o[5] = (_shl(XH, 6) ^ _shr(Q[21], 6) ^ M[5]) + (XL ^ Q[29] ^ Q[5])
    o[6] = (_shr(XH, 4) ^ _shl(Q[22], 6) ^ M[6]) + (XL ^ Q[30] ^ Q[6])
    o[7] = (_shr(XH, 11) ^ _shl(Q[23], 2) ^ M[7]) + (XL ^ Q[31] ^ Q[7])
    o[8] = _rotl(o[4], 9) + (XH ^ Q[24] ^ M[8]) + (_shl(XL, 8) ^ Q[23] ^ Q[8])
    o[9] = _rotl(o[5], 10) + (XH ^ Q[25] ^ M[9]) + (_shr(XL, 6) ^ Q[16] ^ Q[9])
    o[10] = _rotl(o[6], 11) + (XH ^ Q[26] ^ M[10]) + (_shl(XL, 6) ^ Q[17] ^ Q[10])
    o[11] = _rotl(o[7], 12) + (XH ^ Q[27] ^ M[11]) + (_shl(XL, 4) ^ Q[18] ^ Q[11])
    o[12] = _rotl(o[0], 13) + (XH ^ Q[28] ^ M[12]) + (_shr(XL, 3) ^ Q[19] ^ Q[12])
    o[13] = _rotl(o[1], 14) + (XH ^ Q[29] ^ M[13]) + (_shr(XL, 4) ^ Q[20] ^ Q[13])
    o[14] = _rotl(o[2], 15) + (XH ^ Q[30] ^ M[14]) + (_shr(XL, 7) ^ Q[21] ^ Q[14])
    o[15] = _rotl(o[3], 16) + (XH ^ Q[31] ^ M[15]) + (_shr(XL, 2) ^ Q[22] ^ Q[15])
    return o


def bmw512_64(h):
    z = h[0] ^ h[0]
    M = list(h) + [z + 0x80] + [z] * 6 + [z + 512]
    H = _bmw_compress([z + s64(v) for v in bmw.IV512], M)
    H = _bmw_compress([z + s64(v) for v in bmw.FINAL512], H)
    return H[8:]


# -- stage 3: groestl512 -------------------------------------------------------

def _groestl_perm(st, q: bool):
    """P1024 (``q`` False) or Q1024 over ``[B, 16]`` columns."""
    T = _t("groestl", st.device)
    dev = st.device
    cols = torch.arange(16, dtype=torch.int64, device=dev) << 4
    shifts = groestl._SHIFT_Q if q else groestl._SHIFT_P
    idx = [torch.tensor([(c + shifts[i]) % 16 for c in range(16)], device=dev)
           for i in range(8)]
    for r in range(14):
        if q:
            st = st ^ -1 ^ ((cols ^ r) << 56)
        else:
            st = st ^ (cols ^ r)
        out = None
        for i in range(8):
            b = _shr(st[:, idx[i]], 8 * i) & 0xFF
            term = T[i][b]
            out = term if out is None else out ^ term
        st = out
    return st


def groestl512_64(h):
    z = h[0] ^ h[0]
    M = torch.stack(list(h) + [z + 0x80] + [z] * 6 + [z + s64(1 << 56)], 1)
    H = torch.zeros_like(M)
    H[:, 15] = 2 << 48
    H = _groestl_perm(H ^ M, False) ^ _groestl_perm(M, True) ^ H
    out = _groestl_perm(H, False) ^ H
    return list(out[:, 8:].unbind(1))


# -- stage 4: skein512 ---------------------------------------------------------

def _threefish(key, t0: int, t1: int, block):
    k8 = key[0] ^ s64(skein.C240)
    for kk in key[1:]:
        k8 = k8 ^ kk
    k = list(key) + [k8]
    t = [s64(t0), s64(t1), s64(t0 ^ t1)]

    def subkey(s):
        ks = [k[(s + i) % 9] for i in range(8)]
        ks[5] = ks[5] + t[s % 3]
        ks[6] = ks[6] + t[(s + 1) % 3]
        ks[7] = ks[7] + s
        return ks

    v = list(block)
    for d in range(72):
        if d % 4 == 0:
            ks = subkey(d // 4)
            v = [v[i] + ks[i] for i in range(8)]
        rot = skein.R512[d % 8]
        for j in range(4):
            a = v[2 * j] + v[2 * j + 1]
            v[2 * j + 1] = _rotl(v[2 * j + 1], rot[j]) ^ a
            v[2 * j] = a
        v = [v[skein.PERM[i]] for i in range(8)]
    ks = subkey(18)
    return [v[i] + ks[i] for i in range(8)]


def skein512_64(h):
    z = h[0] ^ h[0]
    iv = [z + s64(v) for v in skein.IV512]
    t1 = (skein.T_MSG << 56) | (1 << 62) | (1 << 63)
    e = _threefish(iv, 64, t1, h)
    g = [e[i] ^ h[i] for i in range(8)]
    t1o = (skein.T_OUT << 56) | (1 << 62) | (1 << 63)
    return _threefish(g, 8, t1o, [z] * 8)


# -- stage 5: jh512, bitsliced ---------------------------------------------------

def _jh_sb(x0, x1, x2, x3, c):
    x3 = ~x3
    x0 = x0 ^ (c & ~x2)
    tmp = c ^ (x0 & x1)
    x0 = x0 ^ (x2 & x3)
    x3 = x3 ^ (~x1 & x2)
    x1 = x1 ^ (x0 & x2)
    x2 = x2 ^ (x0 & ~x3)
    x0 = x0 ^ (x1 | x3)
    x3 = x3 ^ (x1 & x2)
    x1 = x1 ^ (tmp & x0)
    x2 = x2 ^ tmp
    return x0, x1, x2, x3


def _jh_lb(x0, x1, x2, x3, x4, x5, x6, x7):
    x4 = x4 ^ x1
    x5 = x5 ^ x2
    x6 = x6 ^ x3 ^ x0
    x7 = x7 ^ x0
    x0 = x0 ^ x5
    x1 = x1 ^ x6
    x2 = x2 ^ x7 ^ x4
    x3 = x3 ^ x4
    return x0, x1, x2, x3, x4, x5, x6, x7


_JH_SWAP = (0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F,
            0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF, 0x00000000FFFFFFFF)


def _jh_swap(x, n: int):
    """Swap bits of one 64-bit word at distance 2^n (n < 6)."""
    m = s64(_JH_SWAP[n])
    return ((x & m) << (1 << n)) | (_shr(x, 1 << n) & m)


def _jh_e8(x):
    """E8 over the 16 words x[2j] (high), x[2j + 1] (low) of 128-bit
    word j = 0..7."""
    _, consts = jh_tables()
    for r in range(42):
        c = [s64(int(v)) for v in consts[r]]
        for half in (0, 1):
            ev = [x[2 * j + half] for j in (0, 2, 4, 6)]
            od = [x[2 * j + half] for j in (1, 3, 5, 7)]
            ev = _jh_sb(*ev, c[half])
            od = _jh_sb(*od, c[2 + half])
            out = _jh_lb(*ev, *od)
            for q, j in enumerate((0, 2, 4, 6)):
                x[2 * j + half] = out[q]
            for q, j in enumerate((1, 3, 5, 7)):
                x[2 * j + half] = out[4 + q]
        n = r % 7
        for j in (1, 3, 5, 7):
            if n == 6:
                x[2 * j], x[2 * j + 1] = x[2 * j + 1], x[2 * j]
            else:
                x[2 * j] = _jh_swap(x[2 * j], n)
                x[2 * j + 1] = _jh_swap(x[2 * j + 1], n)
    return x


def jh512_64(h):
    z = h[0] ^ h[0]
    iv, _ = jh_tables()
    x = [z + s64(int(v)) for v in iv]
    msg = [_bswap64(w) for w in h]
    pad = [z + s64(0x80 << 56)] + [z] * 6 + [z + 512]
    for m in (msg, pad):
        for i in range(8):
            x[i] = x[i] ^ m[i]
        x = _jh_e8(x)
        for i in range(8):
            x[8 + i] = x[8 + i] ^ m[i]
    return [_bswap64(w) for w in x[8:]]


# -- stage 6: keccak512 --------------------------------------------------------

def keccak512_64(h):
    z = h[0] ^ h[0]
    A = list(h) + [z + s64(0x8000000000000001)] + [z] * 16
    for rnd in range(24):
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20]
             for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        A = [A[x + 5 * y] ^ D[x] for y in range(5) for x in range(5)]
        Bl = [None] * 25
        for x in range(5):
            for y in range(5):
                Bl[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(A[x + 5 * y],
                                                          keccak.RHO[x][y])
        A = [Bl[x + 5 * y] ^ (~Bl[(x + 1) % 5 + 5 * y] & Bl[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]
        A[0] = A[0] ^ s64(int(keccak.RC[rnd]))
    return A[:8]


# -- stage 7: luffa512 (32-bit words) -------------------------------------------

def _luffa_m2(x):
    t = x[7]
    return [t, x[0] ^ t, x[1], x[2] ^ t, x[3] ^ t, x[4], x[5], x[6]]


def _luffa_mi5(V, M):
    t = [V[0][i] ^ V[1][i] ^ V[2][i] ^ V[3][i] ^ V[4][i] for i in range(8)]
    t = _luffa_m2(t)
    V = [[V[j][i] ^ t[i] for i in range(8)] for j in range(5)]
    d = [_luffa_m2(v) for v in V]
    V = [[d[j][i] ^ V[(j + 1) % 5][i] for i in range(8)] for j in range(5)]
    d = [_luffa_m2(v) for v in V]
    V = [[d[j][i] ^ V[(j - 1) % 5][i] for i in range(8)] for j in range(5)]
    out, m = [], list(M)
    for j in range(5):
        out.append([V[j][i] ^ m[i] for i in range(8)])
        m = _luffa_m2(m)
    return out


def _luffa_sub_crumb(a0, a1, a2, a3):
    tmp = a0
    a0 = a0 | a1
    a2 = a2 ^ a3
    a1 = a1 ^ M32
    a0 = a0 ^ a3
    a3 = a3 & tmp
    a1 = a1 ^ a3
    a3 = a3 ^ a2
    a2 = a2 & a0
    a0 = a0 ^ M32
    a2 = a2 ^ a1
    a1 = a1 | a3
    tmp = tmp ^ a1
    a3 = a3 ^ a2
    a2 = a2 & a1
    a1 = a1 ^ a0
    return tmp, a1, a2, a3


def _luffa_mix_word(u, v):
    v = v ^ u
    u = _rotl32(u, 2) ^ v
    v = _rotl32(v, 14) ^ u
    u = _rotl32(u, 10) ^ v
    v = _rotl32(v, 1)
    return u, v


def _luffa_q(x, j):
    x = list(x)
    for i in range(4, 8):
        x[i] = _rotl32(x[i], j)
    for step in range(8):
        x[0], x[1], x[2], x[3] = _luffa_sub_crumb(x[0], x[1], x[2], x[3])
        x[5], x[6], x[7], x[4] = _luffa_sub_crumb(x[5], x[6], x[7], x[4])
        for i in range(4):
            x[i], x[i + 4] = _luffa_mix_word(x[i], x[i + 4])
        x[0] = x[0] ^ luffa.CNS[j][step][0]
        x[4] = x[4] ^ luffa.CNS[j][step][1]
    return x


def luffa512_64(h):
    z = h[0] ^ h[0]
    w = [_bswap32(v) for v in _to_u32_le(h)]
    V = [[z + int(luffa.IV[j][i]) for i in range(8)] for j in range(5)]
    out = []
    for M in (w[:8], w[8:], [z + 0x80000000] + [z] * 7, None, None):
        V = _luffa_mi5(V, [z] * 8 if M is None else M)
        V = [_luffa_q(V[j], j) for j in range(5)]
        if M is None:
            out += [V[0][i] ^ V[1][i] ^ V[2][i] ^ V[3][i] ^ V[4][i]
                    for i in range(8)]
    return _from_u32_le([_bswap32(v) for v in out])


# -- stage 8: cubehash512 ------------------------------------------------------

def _cube_perm(pairs_xor: int, lo: bool):
    """Index order that swaps x[i] with x[i ^ pairs_xor] within one half."""
    base = 0 if lo else 16
    return [base + (i ^ pairs_xor) for i in range(16)]


_CUBE_P8 = _cube_perm(8, True) + list(range(16, 32))
_CUBE_P2 = list(range(16)) + _cube_perm(2, False)
_CUBE_P4 = _cube_perm(4, True) + list(range(16, 32))
_CUBE_P1 = list(range(16)) + _cube_perm(1, False)


def _cube_rounds(x, n: int):
    """``n`` CubeHash rounds over ``[B, 32]`` words."""
    dev = x.device
    p8, p2, p4, p1 = (torch.tensor(p, device=dev)
                      for p in (_CUBE_P8, _CUBE_P2, _CUBE_P4, _CUBE_P1))
    for _ in range(n):
        lo, hi = x[:, :16], (x[:, 16:] + x[:, :16]) & M32
        x = torch.cat([_rotl32(lo, 7), hi], 1)[:, p8]
        x = torch.cat([x[:, :16] ^ x[:, 16:], x[:, 16:]], 1)[:, p2]
        lo, hi = x[:, :16], (x[:, 16:] + x[:, :16]) & M32
        x = torch.cat([_rotl32(lo, 11), hi], 1)[:, p4]
        x = torch.cat([x[:, :16] ^ x[:, 16:], x[:, 16:]], 1)[:, p1]
    return x


def cubehash512_64(h):
    w = torch.stack(_to_u32_le(h), 1)
    x = torch.as_tensor(cubehash_iv().astype(np.int64),
                        device=w.device).expand(w.shape[0], 32).clone()
    for blk in range(2):
        x[:, :8] ^= w[:, 8 * blk:8 * blk + 8]
        x = _cube_rounds(x, 16)
    x[:, 0] ^= 0x80
    x = _cube_rounds(x, 16)
    x[:, 31] ^= 1
    x = _cube_rounds(x, 160)
    return _from_u32_le(list(x[:, :16].unbind(1)))


# -- the AES round on 32-bit columns (shavite, echo) ---------------------------

def _aes(x, key=None):
    """One AES round (SubBytes, ShiftRows, MixColumns, AddRoundKey) on
    ``[..., 4]`` little-endian 32-bit columns."""
    T = _t("aes", x.device)
    out = T[0][x & 0xFF]
    for i in range(1, 4):
        out = out ^ T[i][(x.roll(-i, -1) >> (8 * i)) & 0xFF]
    return out if key is None else out ^ key


# -- stage 9: shavite512 -------------------------------------------------------

def cnt_variant_order(variant: str | None = None) -> list[list[int]]:
    """The shavite counter-injection order ``[4][4]`` (injections at
    subkey words 32, 164, 316, 440): ``variant`` or the active one."""
    inject = shavite.CNT_VARIANTS[variant or shavite.active_cnt_variant()]
    return [list(inject[u]) for u in (32, 164, 316, 440)]


def shavite512_64(h, cnt_order=None):
    z = h[0] ^ h[0]
    order = cnt_order or cnt_variant_order()
    cnt = (512, 0, 0, 0)
    inject = {u: order[i] for i, u in enumerate((32, 164, 316, 440))}
    rk = _to_u32_le(h) + [z + 0x80] + [z] * 10 + [z + (512 << 16)] \
        + [z] * 3 + [z + (512 << 16)]
    u, nonlinear = 32, True
    while u < shavite.RK_WORDS:
        for _ in range(8):
            if nonlinear:
                x = _aes(torch.stack([rk[u - 31], rk[u - 30], rk[u - 29],
                                      rk[u - 32]], -1))
                rk += [x[..., j] ^ rk[u - 4 + j] for j in range(4)]
                if u in inject:
                    for j in range(4):
                        wv = cnt[inject[u][j]]
                        rk[u + j] = rk[u + j] ^ (wv ^ M32 if j == 3 else wv)
            else:
                rk += [rk[u - 32 + j] ^ rk[u - 7 + j] for j in range(4)]
            u += 4
        nonlinear = not nonlinear
    keys = torch.stack(rk, -1)                          # [B, 448]
    hv = torch.tensor(shavite.IV512, dtype=torch.int64, device=keys.device)
    hv = hv.expand(keys.shape[0], 16)
    p = [hv[:, 4 * q:4 * q + 4] for q in range(4)]

    def f4(x, k):
        t = x ^ k[:, 0:4]
        for r in range(1, 4):
            t = _aes(t) ^ k[:, 4 * r:4 * r + 4]
        return _aes(t)

    for r in range(shavite.ROUNDS):
        k = keys[:, 32 * r:32 * r + 32]
        p0 = p[0] ^ f4(p[1], k[:, :16])
        p2 = p[2] ^ f4(p[3], k[:, 16:])
        p = [p[3], p0, p[1], p2]
    out = hv ^ torch.cat(p, 1)
    return _from_u32_le(list(out.unbind(1)))


# -- stage 10: simd512 ---------------------------------------------------------

def ntt257(x):
    """y[k] = sum_j x[j] * 41^(jk) mod 257 over ``[B, 256]`` (values in
    [0, 257)), by radix-2 butterflies on the bit-reversed input."""
    dev = x.device
    rev = torch.tensor([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                       device=dev)
    a = x[:, rev]
    wp = _t("omega_pow", dev)
    B = a.shape[0]
    length = 2
    while length <= 256:
        half = length // 2
        a = a.view(B, 256 // length, 2, half)
        w = wp[torch.arange(half, device=dev) * (256 // length)]
        u = a[:, :, 0, :]
        v = (a[:, :, 1, :] * w) % 257
        a = torch.stack([(u + v) % 257, (u - v) % 257], 2).reshape(B, 256)
        length *= 2
    return a


def _simd_expand(xbytes):
    """The expanded message words ``[B, 256]`` of a non-final block whose
    128 bytes are ``xbytes`` [B, 128]."""
    x = torch.zeros(xbytes.shape[0], 256, dtype=torch.int64,
                    device=xbytes.device)
    x[:, :128] = xbytes
    y = ntt257(x)
    s = (y * _t("twist", x.device)) % 257
    s = torch.where(s > 128, s - 257, s)
    return (s & 0xFFFF) | ((s.roll(-128, 1) & 0xFFFF) << 16)


def _simd_compress(state, m32, W):
    """state ``[B, 32]`` (A|B|C|D), m32 ``[B, 32]`` the block's LE words,
    W ``[B, 256]`` (or ``[256]``) the expanded words."""
    saved = state
    st = state ^ m32
    A, Bv, C, D = st[:, 0:8], st[:, 8:16], st[:, 16:24], st[:, 24:32]

    def step(A, Bv, C, D, w, use_if, r, s, p):
        tA = _rotl32(A, r)
        f = (((Bv ^ C) & A) ^ C) if use_if else ((C & Bv) | ((C | Bv) & A))
        newA = (_rotl32((D + w + f) & M32, s) + tA[:, [j ^ p for j in range(8)]]) & M32
        return newA, tA, Bv, C

    for stp in range(32):
        rnd, k = divmod(stp, 8)
        c = simd.ROUND_ROTS[rnd]
        base = simd.WSP[stp] * 8
        w = W[..., base:base + 8]
        A, Bv, C, D = step(A, Bv, C, D, w, k < 4, c[k % 4], c[(k + 1) % 4],
                           simd.PMASK[stp])
    for fs in range(4):
        r, s = simd.FF_ROTS[fs]
        A, Bv, C, D = step(A, Bv, C, D, saved[:, 8 * fs:8 * fs + 8], True,
                           r, s, simd.PMASK[32 + fs])
    return torch.cat([A, Bv, C, D], 1)


def simd512_64(h):
    w = torch.stack(_to_u32_le(h), 1)                      # [B, 16]
    B, dev = w.shape[0], w.device
    xbytes = torch.stack([(w >> (8 * b)) & 0xFF for b in range(4)],
                         2).reshape(B, 64)
    xbytes = torch.cat([xbytes, torch.zeros_like(xbytes)], 1)
    state = torch.tensor(simd.IV512, dtype=torch.int64, device=dev)
    state = state.expand(B, 32)
    m32 = torch.cat([w, torch.zeros_like(w)], 1)
    state = _simd_compress(state, m32, _simd_expand(xbytes))
    lb = torch.zeros_like(m32)
    lb[:, 0] = 512
    state = _simd_compress(state, lb, _t("w_final", dev))
    return _from_u32_le(list(state[:, :16].unbind(1)))


# -- stage 11: echo512 ---------------------------------------------------------

_ECHO_BIG_SHIFT = [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)]


def _mul2(x):
    """Byte-wise doubling in GF(2^8) of four packed bytes."""
    return (((x & 0x7F7F7F7F) << 1)
            ^ (((x >> 7) & 0x01010101) * 0x1B)) & M32


def echo512_64(h, words: int = 16):
    """The first ``words`` 32-bit words of the digest (16: all 64 bytes;
    the chain needs 8)."""
    w = torch.stack(_to_u32_le(h), 1)                      # [B, 16]
    B, dev = w.shape[0], w.device
    iv = torch.tensor([512, 0, 0, 0], dtype=torch.int64, device=dev)
    V = iv.expand(B, 8, 4)
    pad = torch.tensor([[0x80, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 512 << 16],
                        [512, 0, 0, 0]], dtype=torch.int64, device=dev)
    M = torch.cat([w.view(B, 4, 4), pad.expand(B, 4, 4)], 1)
    st = torch.cat([V, M], 1)                              # [B, 16, 4]
    shift = torch.tensor(_ECHO_BIG_SHIFT, device=dev)
    k = 512
    for _ in range(10):
        key = torch.zeros(16, 4, dtype=torch.int64, device=dev)
        key[:, 0] = torch.arange(k, k + 16, device=dev)
        k += 16
        st = _aes(_aes(st, key))
        st = st[:, shift, :]
        cols = st.view(B, 4, 4, 4)                         # [B, col, row, word]
        a0, a1, a2, a3 = cols.unbind(2)
        st = torch.stack([
            _mul2(a0) ^ _mul2(a1) ^ a1 ^ a2 ^ a3,
            a0 ^ _mul2(a1) ^ _mul2(a2) ^ a2 ^ a3,
            a0 ^ a1 ^ _mul2(a2) ^ _mul2(a3) ^ a3,
            _mul2(a0) ^ a0 ^ a1 ^ a2 ^ _mul2(a3),
        ], 2).reshape(B, 16, 4)
    out = (V ^ M[:, :8] ^ st[:, :8] ^ st[:, 8:]).reshape(B, 32)
    return out[:, :words]


# -- the chain -------------------------------------------------------------------

def header_words64(words20):
    """``[B, 20]`` big-endian 32-bit header words (int64 values) -> the ten
    big-endian 64-bit words blake512 takes."""
    return [(words20[:, 2 * i] << 32) | words20[:, 2 * i + 1]
            for i in range(10)]


def chain_words(words20, cnt_order=None):
    """The x11 chain over ``[B, 20]`` header words (int64 values in
    [0, 2^32)). Returns the digest's first 32 bytes as ``[B, 8]``
    little-endian 32-bit words."""
    h = blake512_80(header_words64(words20))
    h = bmw512_64(h)
    h = groestl512_64(h)
    h = skein512_64(h)
    h = jh512_64(h)
    h = keccak512_64(h)
    h = luffa512_64(h)
    h = cubehash512_64(h)
    h = shavite512_64(h, cnt_order)
    h = simd512_64(h)
    return echo512_64(h, words=8)


def x11_digest_chain(headers, cnt_variant: str | None = None):
    """``[B, 80]`` uint8 headers (numpy or tensor) -> ``[B, 32]`` uint8
    digests (a numpy array), the JAX package's ``x11_digest_chain``."""
    hb = np.asarray(headers.cpu() if torch.is_tensor(headers) else headers,
                    dtype=np.uint8)
    words = torch.from_numpy(headers_to_words(hb).astype(np.int64))
    d = chain_words(words, cnt_variant_order(cnt_variant))
    return d.numpy().astype("<u4").view(np.uint8).reshape(-1, 32)


def digest_limbs(d32):
    """``[B, 8]`` digest words (LE 32-bit, int64) -> the 8
    most-significant-first limbs of the little-endian 256-bit value
    (limb j is word 7 - j), as ``jnp_chain.digest_limbs`` gives them."""
    return tuple(d32[:, 7 - j] for j in range(8))


def x11_winner_step(words20, limbs8, last: int, *, k: int, cnt_order=None):
    """The search step: ``[B, 20]`` header words (lane offsets 0..B-1),
    an exact 256-bit compare against one target's limbs, winners (lane
    offsets) compacted into ``uint32[2k+3]`` (int64 values); lanes past
    ``last`` take part in neither the winners nor the min top limb."""
    h = digest_limbs(chain_words(words20, cnt_order))
    hits = le256(h, [int(x) for x in limbs8])
    offs = torch.arange(words20.shape[0], dtype=torch.int64,
                        device=words20.device)
    rng = offs <= last
    return compact_winners(hits & rng, torch.where(rng, h[0], M32), offs, k)


def search_words(prefix76: bytes, base: int, lanes: int, device):
    """The ``[lanes, 20]`` header words of a window: the 76-byte prefix and
    the nonce word base + offset (mod 2^32) at bytes 76:80, big-endian."""
    pre = np.frombuffer(prefix76, dtype=">u4").astype(np.int64)
    words = torch.empty(lanes, 20, dtype=torch.int64, device=device)
    words[:, :19] = torch.as_tensor(pre, device=device)
    words[:, 19] = (torch.arange(lanes, dtype=torch.int64, device=device)
                    + base) & M32
    return words


def x11_search_buffers(prefix76: bytes, windows, limbs8, *, k: int, device,
                       cnt_order=None, chunk: int = 1 << 18):
    """The search kernel's buffers for several windows ``(base, lanes,
    last)`` of one job, their lanes hashed together in chain calls of at
    most ``chunk`` lanes (a call costs about the same for few lanes as for
    many): one ``uint32[2k+3]`` buffer a window (winners as lane offsets
    from its base; lanes past offset ``last`` out of range), as int64
    values ``[len(windows), 2k+3]`` on ``device``."""
    calls.add()
    device = torch.device(device)
    spans = [max(0, min(lanes, last + 1)) for _, lanes, last in windows]
    words = torch.cat([search_words(prefix76, base & M32, n, device)
                       for (base, _, _), n in zip(windows, spans)]
                      + [torch.empty(0, 20, dtype=torch.int64, device=device)])
    limbs = []
    for c0 in range(0, words.shape[0], chunk):
        d = chain_words(words[c0:c0 + chunk], cnt_order)
        limbs.append(torch.stack(digest_limbs(d), 1))
    h = torch.cat(limbs + [torch.empty(0, 8, dtype=torch.int64,
                                       device=device)])
    target = [int(x) for x in limbs8]
    bufs, at = [], 0
    for n in spans:
        hw = h[at:at + n]
        at += n
        hits = le256(hw.unbind(1), target)
        offs = torch.arange(n, dtype=torch.int64, device=device)
        bufs.append(compact_winners(hits, hw[:, 0], offs, k))
    return torch.stack(bufs)


def x11_search_buffer(prefix76: bytes, base: int, last: int, limbs8, *,
                      batch: int, k: int, device, cnt_order=None,
                      chunk: int = 1 << 18):
    """The search kernel's result in plain tensor ops: ``batch`` lanes from
    nonce word ``base`` (wrapping mod 2^32), lanes past offset ``last``
    (-1: none in range) out of range. Returns the ``uint32[2k+3]`` buffer
    (winners as lane offsets) as an int32 tensor on ``device``."""
    buf = x11_search_buffers(prefix76, [(base, batch, last)], limbs8, k=k,
                             device=device, cnt_order=cnt_order,
                             chunk=chunk)[0]
    return (buf - ((buf >> 31) << 32)).to(torch.int32)


def x11_verify_step(words20, limbs, last: int, *, k: int, cnt_order=None):
    """Share validation: ``[B, 20]`` header words against per-lane
    ``[B, 8]`` target limbs; failures (lane offsets) compacted by
    ``compact_failures``. Takes int32 bit patterns or int64 words; returns
    the ``uint32[2k+3]`` buffer as an int32 tensor on the inputs' device.
    The plain version of the verify kernel (``x11_cuda.x11_verify``)."""
    calls.add()
    words = words20.to(torch.int64) & M32
    lb = limbs.to(torch.int64) & M32
    h = digest_limbs(chain_words(words, cnt_order))
    passes = le256(h, lb.unbind(1))
    buf = compact_failures(passes, h[0], int(last), k)
    return (buf - ((buf >> 31) << 32)).to(torch.int32)
