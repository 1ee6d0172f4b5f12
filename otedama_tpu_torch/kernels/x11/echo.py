"""ECHO-512 (AES-based SHA-3 candidate — x11 stage 11, the final stage).

Lane-axis implementation. The 2048-bit state is 16 AES-style 128-bit words
arranged 4x4 (word i at row i%4, col i//4), kept as a ``[B, 16, 16]`` uint8
array (word, byte; bytes column-major within the word as in AES).

Per round: BIG.SubWords (two full AES rounds per word — first keyed by the
incrementing 128-bit counter, second by the salt = 0), BIG.ShiftRows over
words, BIG.MixColumns (AES 2-3-1-1 MDS byte-wise across the words of each
column). ECHO-512: 10 rounds, chaining/message are 8 words each,
feedforward V'_i = V_i ^ M_i ^ w_i ^ w_{i+8}.

IV: each chaining word = digest bit length (512) as a little-endian 128-bit
integer. Padding: 0x80, zeros, 2-byte LE digest size, 16-byte LE bit count.
Counter = message bits processed including the current block (0 for blocks
holding no message bits), loaded little-endian into the round key and
incremented once per SubWords word.

Validation status: AES machinery shared with groestl (whose KAT passes);
ECHO-level structure is spec-faithful from the submission document, no
offline oracle. Structural tests only.
"""

from __future__ import annotations

import numpy as np

from otedama_tpu_torch.kernels.x11.groestl import aes_sbox, _gf_tables

# AES ShiftRows byte permutation for a column-major 16-byte state:
# byte index = 4*col + row; row r rotates left by r columns.
_AES_SHIFT = np.array(
    [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)], dtype=np.int64
)


def _mix_columns(cols: np.ndarray, axis_row: int) -> np.ndarray:
    """AES 2-3-1-1 MDS along ``axis_row`` (length 4) of any byte tensor."""
    gf = _gf_tables()
    m2, m3 = gf[2], gf[3]
    a = np.moveaxis(cols, axis_row, 0)
    a0, a1, a2, a3 = a[0], a[1], a[2], a[3]
    out = np.empty_like(a)
    out[0] = m2[a0] ^ m3[a1] ^ a2 ^ a3
    out[1] = a0 ^ m2[a1] ^ m3[a2] ^ a3
    out[2] = a0 ^ a1 ^ m2[a2] ^ m3[a3]
    out[3] = m3[a0] ^ a1 ^ a2 ^ m2[a3]
    return np.moveaxis(out, 0, axis_row)


def _aes_round(w: np.ndarray, key: np.ndarray) -> np.ndarray:
    """One AES round on ``[B, 16]`` states (column-major bytes).
    ``key``: broadcastable ``[..., 16]`` uint8."""
    sbox = aes_sbox()
    s = sbox[w][:, _AES_SHIFT]
    cols = s.reshape(s.shape[0], 4, 4)  # [B, col, row]
    return _mix_columns(cols, 2).reshape(w.shape) ^ key


# BIG.ShiftRows: word at (row r, col c) moves to col (c - r) mod 4;
# equivalently new[(r, c)] = old[(r, (c + r) % 4)], word index = r + 4*c.
_BIG_SHIFT = np.array(
    [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)], dtype=np.int64
)


def echo512_compress(V: np.ndarray, M: np.ndarray, counter: int) -> np.ndarray:
    """One ECHO-512 compression. ``V``/``M``: ``[B, 8, 16]`` uint8 words."""
    B = V.shape[0]
    state = np.concatenate([V, M], axis=1)  # [B, 16, 16]
    k = counter
    zero_key = np.zeros(16, dtype=np.uint8)
    for _ in range(10):
        # BIG.SubWords
        new = np.empty_like(state)
        for i in range(16):
            key = np.frombuffer(
                int(k).to_bytes(16, "little"), dtype=np.uint8
            )
            w = _aes_round(state[:, i, :], key)
            new[:, i, :] = _aes_round(w, zero_key)
            k += 1
        # BIG.ShiftRows
        state = new[:, _BIG_SHIFT, :]
        # BIG.MixColumns: words grouped by column (4 consecutive indices)
        cols = state.reshape(B, 4, 4, 16)  # [B, col, row, byte]
        state = _mix_columns(cols, 2).reshape(B, 16, 16)
    return V ^ M ^ state[:, :8, :] ^ state[:, 8:, :]


def echo512(data_bytes: np.ndarray, n_bytes: int) -> np.ndarray:
    """ECHO-512 across lanes. ``data_bytes``: uint8 ``[B, n_bytes]``.
    Returns ``[B, 64]`` digest bytes (first 4 chaining words)."""
    data_bytes = np.atleast_2d(data_bytes)
    B = data_bytes.shape[0]
    bitlen = n_bytes * 8
    # pad: 0x80, zeros, 2-byte LE digest size, 16-byte LE bit length
    n_blocks = (n_bytes + 1 + 18 + 127) // 128
    padded = np.zeros((B, n_blocks * 128), dtype=np.uint8)
    padded[:, :n_bytes] = data_bytes
    padded[:, n_bytes] = 0x80
    padded[:, -18:-16] = np.frombuffer((512).to_bytes(2, "little"), dtype=np.uint8)
    padded[:, -16:] = np.frombuffer(bitlen.to_bytes(16, "little"), dtype=np.uint8)

    iv_word = np.frombuffer((512).to_bytes(16, "little"), dtype=np.uint8)
    V = np.broadcast_to(iv_word, (B, 8, 16)).copy()
    for blk in range(n_blocks):
        M = padded[:, blk * 128 : (blk + 1) * 128].reshape(B, 8, 16)
        # counter: message bits up to and including this block; 0 if the
        # block holds no message bits
        c = min(bitlen, (blk + 1) * 1024)
        if c - blk * 1024 <= 0:
            c = 0
        V = echo512_compress(V, M, c)
    return V[:, :4, :].reshape(B, 64)


def echo512_bytes(data: bytes) -> bytes:
    arr = (
        np.frombuffer(data, dtype=np.uint8)[None, :]
        if data
        else np.zeros((1, 0), dtype=np.uint8)
    )
    return echo512(arr, len(data))[0].tobytes()
