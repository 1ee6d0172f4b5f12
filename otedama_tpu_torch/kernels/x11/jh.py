"""JH-512 (x11 stage 5).

Lane-axis implementation in the *grouped* domain of the JH spec: the
1024-bit state is 256 four-bit elements ``[B, 256]`` (uint8), a round is
S-box substitution (S0/S1 selected per element by the round-constant bit),
the L transform over GF(2^4)/x^4+x+1 on element pairs, and the permutation
P8 = phi ∘ P' ∘ pi.

Two layout details matter for cross-implementation parity (both bit this
module in an earlier round):
- E8's initial grouping makes q_i from state bits (i, i+256, i+512, i+768)
  and then INTERLEAVES: A[2i] = q_i, A[2i+1] = q_{i+128} (inverse applied
  at the final degroup).
- The 42 round constants live natively as 64 NIBBLES (consecutive 4-bit
  groups of the 256-bit constant, i.e. the hex digits of C_0): the schedule
  C_{r+1} = R6(C_r) applies S0/L/P6 on that nibble array directly, and the
  selector for element A[i] is flat bit i of the constant string.
C_0 = the first 256 bits of frac(sqrt(2)).

The IV is derived per spec: H(-1) = digest size (512) as 16-bit BE in the
first two bytes, H(0) = F8(H(-1), 0^512).

Validated against the JH-512 ShortMsgKAT Len=0 digest (90ecf2f7...).
"""

from __future__ import annotations

import functools

import numpy as np

S0 = np.array([9, 0, 4, 11, 13, 12, 3, 15, 1, 10, 2, 6, 7, 5, 8, 14], dtype=np.uint8)
S1 = np.array([3, 12, 6, 13, 5, 7, 1, 9, 15, 2, 0, 4, 11, 10, 14, 8], dtype=np.uint8)

# mul2 over GF(2^4) with x^4 + x + 1 (big-endian nibble: bit3 = x^3 coeff)
_MUL2 = np.array(
    [((v << 1) ^ (0b0011 if v & 0b1000 else 0)) & 0xF for v in range(16)],
    dtype=np.uint8,
)


def _perm_indices(d: int) -> np.ndarray:
    """Index map for P_d: out[i] = in[P[i]] composed from pi, P', phi."""
    n = 1 << d
    # pi_d: in each group of 4, swap positions 2 and 3
    pi = np.arange(n)
    for i in range(0, n, 4):
        pi[i + 2], pi[i + 3] = pi[i + 3], pi[i + 2]
    # P'_d: first half takes even indices, second half odd
    pp = np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])
    # phi_d: second half swaps adjacent pairs
    phi = np.arange(n)
    for i in range(n // 2, n, 2):
        phi[i], phi[i + 1] = phi[i + 1], phi[i]
    # composition: out = phi(P'(pi(A)))  =>  out[i] = A[pi[pp[phi[i]]]]
    return pi[pp[phi]]


def _round(A: np.ndarray, cbits: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """One R_d round: S-box layer, L layer, permutation.

    ``A``: ``[..., n]`` uint8 elements; ``cbits``: ``[n]`` 0/1 S-box select.
    """
    A = np.where(cbits.astype(bool), S1[A], S0[A])
    a = A[..., 0::2]
    b = A[..., 1::2]
    b = b ^ _MUL2[a]
    a = a ^ _MUL2[b]
    A = np.empty_like(A)
    A[..., 0::2] = a
    A[..., 1::2] = b
    return A[..., perm]


def _group_bits(bits: np.ndarray, d: int) -> np.ndarray:
    """bits ``[..., 4*2^d]`` (0/1) -> elements ``[..., 2^d]``:
    element i = (b_i, b_{i+n}, b_{i+2n}, b_{i+3n}) msb-first."""
    n = 1 << d
    return (
        (bits[..., 0:n] << 3)
        | (bits[..., n : 2 * n] << 2)
        | (bits[..., 2 * n : 3 * n] << 1)
        | bits[..., 3 * n : 4 * n]
    ).astype(np.uint8)


def _degroup_bits(A: np.ndarray, d: int) -> np.ndarray:
    n = 1 << d
    out = np.empty(A.shape[:-1] + (4 * n,), dtype=np.uint8)
    out[..., 0:n] = (A >> 3) & 1
    out[..., n : 2 * n] = (A >> 2) & 1
    out[..., 2 * n : 3 * n] = (A >> 1) & 1
    out[..., 3 * n : 4 * n] = A & 1
    return out


def _bytes_to_bits(b: np.ndarray) -> np.ndarray:
    """uint8 ``[..., nbytes]`` -> bits ``[..., 8*nbytes]`` msb-first."""
    return np.unpackbits(b, axis=-1)


def _bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, axis=-1)


@functools.lru_cache(maxsize=1)
def _interleave() -> tuple[np.ndarray, np.ndarray]:
    """E8 layout: A[2i] = q_i, A[2i+1] = q_{i+128}; plus its inverse."""
    inter = np.empty(256, dtype=np.intp)
    inter[0::2] = np.arange(128)
    inter[1::2] = np.arange(128, 256)
    return inter, np.argsort(inter)


@functools.lru_cache(maxsize=1)
def round_constants() -> np.ndarray:
    """The 42 E8 round constants as ``[42, 256]`` selector-bit arrays.

    The schedule runs on the constant's native 64-nibble representation
    (nibble j = hex digit j of C_0): S0 on every nibble, L on pairs, P6.
    Selector bit i for element A[i] is flat bit i of the 256-bit constant.
    """
    c0_hex = (
        "6a09e667f3bcc908b2fb1366ea957d3e3adec17512775099da2f590b0667322a"
    )
    nib = np.array([int(c, 16) for c in c0_hex], dtype=np.uint8)
    perm6 = _perm_indices(6)
    out = []
    for _ in range(42):
        out.append(np.unpackbits(nib[:, None], axis=1)[:, 4:].reshape(-1))
        A = S0[nib]
        a = A[0::2]
        b = A[1::2]
        b = b ^ _MUL2[a]
        a = a ^ _MUL2[b]
        nxt = np.empty_like(A)
        nxt[0::2] = a
        nxt[1::2] = b
        nib = nxt[perm6]
    return np.stack(out)


def _e8(A: np.ndarray) -> np.ndarray:
    perm8 = _perm_indices(8)
    C = round_constants()
    for r in range(42):
        A = _round(A, C[r], perm8)
    return A


def _f8(H_bytes: np.ndarray, M_bytes: np.ndarray) -> np.ndarray:
    """F8 compression: xor M into the first 512 state bits, E8, xor M into
    the last 512 bits. ``H_bytes``: ``[B, 128]``, ``M_bytes``: ``[B, 64]``."""
    inter, deinter = _interleave()
    H = H_bytes.copy()
    H[:, :64] ^= M_bytes
    bits = _bytes_to_bits(H)
    A = _group_bits(bits, 8)[..., inter]
    A = _e8(A)
    out = _bits_to_bytes(_degroup_bits(A[..., deinter], 8))
    out[:, 64:] ^= M_bytes
    return out


@functools.lru_cache(maxsize=1)
def _iv512() -> np.ndarray:
    H = np.zeros((1, 128), dtype=np.uint8)
    H[0, 0] = 0x02  # 512 as 16-bit big-endian in the first two bytes
    H[0, 1] = 0x00
    return _f8(H, np.zeros((1, 64), dtype=np.uint8))[0]


def jh512(data_bytes: np.ndarray, n_bytes: int) -> np.ndarray:
    """JH-512 across lanes. ``data_bytes``: uint8 ``[B, n_bytes]``.
    Returns ``[B, 64]`` digest bytes (last 512 state bits)."""
    data_bytes = np.atleast_2d(data_bytes)
    B = data_bytes.shape[0]
    bitlen = n_bytes * 8
    # pad with 0x80, zeros, 128-bit BE length; total padding in [512, 1023] bits
    rem = (n_bytes + 1 + 16) % 64
    pad_zeros = (64 - rem) % 64
    total = n_bytes + 1 + pad_zeros + 16
    if total - n_bytes < 64:
        total += 64
    padded = np.zeros((B, total), dtype=np.uint8)
    padded[:, :n_bytes] = data_bytes
    padded[:, n_bytes] = 0x80
    padded[:, -16:] = np.frombuffer(bitlen.to_bytes(16, "big"), dtype=np.uint8)

    H = np.broadcast_to(_iv512(), (B, 128)).copy()
    for blk in range(total // 64):
        H = _f8(H, padded[:, blk * 64 : (blk + 1) * 64])
    return H[:, 64:]


def jh512_bytes(data: bytes) -> bytes:
    arr = (
        np.frombuffer(data, dtype=np.uint8)[None, :]
        if data
        else np.zeros((1, 0), dtype=np.uint8)
    )
    return jh512(arr, len(data))[0].tobytes()
