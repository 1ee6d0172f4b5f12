"""Groestl-512 (final-round tweaked Grøstl — x11 stage 3).

Lane-axis implementation: the 8x16-byte "big" state is a ``[B, 8, 16]``
uint8 numpy array (row, column), so SubBytes is one table gather and
MixBytes is eight rolled adds over the row axis for the whole nonce batch.

The AES S-box is derived from its definition (GF(2^8) inverse + affine map)
rather than pasted, and asserted against its two defining fixed points in
tests. GF doubling tables are built from the AES polynomial 0x11B.

Construction (spec): 14 rounds; P adds (j<<4)^r to row 0, Q complements the
state and adds (j<<4)^r to row 7; ShiftBytes P=(0,1,2,3,4,5,6,11),
Q=(1,3,5,11,0,2,4,6); MixBytes = circ(02,02,03,04,05,03,05,07);
compression H' = P(H^M) ^ Q(M) ^ H; output = trunc_512(P(H) ^ H).
Input maps to the matrix column-major (byte k -> row k%8, col k//8).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def aes_sbox() -> np.ndarray:
    """Derive the AES S-box: multiplicative inverse in GF(2^8)/0x11B
    followed by the affine transform b ^ rot(b,1..4) ^ 0x63."""
    # build inverse table via exp/log over generator 3
    exp = [0] * 510
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply by generator 0x03 = x+1
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 510):
        exp[i] = exp[i - 255]
    inv = [0] * 256
    for a in range(1, 256):
        inv[a] = exp[255 - log[a]]
    sbox = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        b = inv[a]
        s = b
        for k in range(1, 5):
            s ^= ((b << k) | (b >> (8 - k))) & 0xFF
        sbox[a] = s ^ 0x63
    return sbox


@functools.lru_cache(maxsize=1)
def _gf_tables() -> dict[int, np.ndarray]:
    """uint8 multiply-by-{2,3,4,5,7} tables over GF(2^8)/0x11B."""
    a = np.arange(256, dtype=np.uint16)
    x2 = ((a << 1) ^ np.where(a & 0x80, 0x11B, 0)).astype(np.uint8)
    a8 = a.astype(np.uint8)
    x2u = x2
    x3 = x2u ^ a8
    x4 = ((x2.astype(np.uint16) << 1) ^ np.where(x2 & 0x80, 0x11B, 0)).astype(np.uint8)
    x5 = x4 ^ a8
    x7 = x4 ^ x2u ^ a8
    return {2: x2u, 3: x3, 4: x4, 5: x5, 7: x7}


_SHIFT_P = (0, 1, 2, 3, 4, 5, 6, 11)
_SHIFT_Q = (1, 3, 5, 11, 0, 2, 4, 6)
_MIX = (2, 2, 3, 4, 5, 3, 5, 7)


def _permute(state: np.ndarray, variant: str) -> np.ndarray:
    """P1024 or Q1024 over ``[B, 8, 16]`` uint8 lanes."""
    sbox = aes_sbox()
    gf = _gf_tables()
    shifts = _SHIFT_P if variant == "P" else _SHIFT_Q
    cols = np.arange(16, dtype=np.uint8) << 4
    for r in range(14):
        if variant == "P":
            state = state.copy()
            state[:, 0, :] ^= cols ^ np.uint8(r)
        else:
            # complement every byte, then row 7 additionally gets (j<<4)^r
            state = state ^ np.uint8(0xFF)
            state[:, 7, :] ^= cols ^ np.uint8(r)
        state = sbox[state]
        for i in range(8):
            state[:, i, :] = np.roll(state[:, i, :], -shifts[i], axis=-1)
        out = np.zeros_like(state)
        for m, mult in enumerate(_MIX):
            rolled = np.roll(state, -m, axis=1)  # a[(i+m)%8]
            out ^= gf[mult][rolled] if mult != 1 else rolled
        state = out
    return state


def _q_fixed(state: np.ndarray) -> np.ndarray:
    return _permute(state, "Q")


def groestl512(data_bytes: np.ndarray, n_bytes: int) -> np.ndarray:
    """Groestl-512 across lanes.

    ``data_bytes``: uint8 ``[B, n_bytes]``. Returns ``[B, 64]`` digest bytes.
    """
    data_bytes = np.atleast_2d(data_bytes)
    B = data_bytes.shape[0]
    # pad: 0x80, zeros, final 8 bytes = big-endian total block count
    n_blocks = (n_bytes + 1 + 8 + 127) // 128
    padded = np.zeros((B, n_blocks * 128), dtype=np.uint8)
    padded[:, :n_bytes] = data_bytes
    padded[:, n_bytes] = 0x80
    padded[:, -8:] = np.frombuffer(
        int(n_blocks).to_bytes(8, "big"), dtype=np.uint8
    )

    H = np.zeros((B, 8, 16), dtype=np.uint8)
    # IV: 512 encoded big-endian in the last 8 bytes -> byte 126 = 0x02
    H[:, 6, 15] = 0x02  # byte index 126 -> row 6, col 15
    for blk in range(n_blocks):
        M = (
            padded[:, blk * 128 : (blk + 1) * 128]
            .reshape(B, 16, 8)
            .transpose(0, 2, 1)  # byte k -> row k%8, col k//8
        )
        H = _permute(H ^ M, "P") ^ _q_fixed(M) ^ H
    out = _permute(H, "P") ^ H
    # back to byte order, take last 64 bytes
    flat = out.transpose(0, 2, 1).reshape(B, 128)
    return flat[:, 64:]


def groestl512_bytes(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)[None, :]
    if len(data) == 0:
        arr = np.zeros((1, 0), dtype=np.uint8)
    return groestl512(arr, len(data))[0].tobytes()
