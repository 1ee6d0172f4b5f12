"""Difficulty / target arithmetic.

Exact 256-bit integer target math on the host, and 8x-uint32-limb
representations for on-device comparison. The reference approximates the
share check by counting leading zero bytes (internal/mining/workers.go:407-430)
— we implement the correct big-int comparison instead, as its own
``DifficultyToTarget`` (internal/mining/multi_algorithm.go:196-221) and
``bitsToTarget`` (internal/mining/hardware_accelerated.go:336-356) intend.
"""

from __future__ import annotations

import numpy as np

# Difficulty-1 ("diff1") target used by bitcoin-family pools:
# 0x00000000FFFF0000...0000  (compact bits 0x1d00ffff).
DIFF1_TARGET = 0xFFFF * (1 << 208)
MAX_TARGET = (1 << 256) - 1


def bits_to_target(nbits: int) -> int:
    """Decode the compact 'nBits' encoding of a block header into a target.

    compact = (exponent << 24) | mantissa ; target = mantissa * 256^(exponent-3)
    Handles the sign bit quirk (mantissa high bit set => shift right).
    """
    exponent = nbits >> 24
    mantissa = nbits & 0x007FFFFF
    if nbits & 0x00800000:
        # sign bit set: negative targets are invalid for PoW; treat as zero
        return 0
    if exponent <= 3:
        return mantissa >> (8 * (3 - exponent))
    return mantissa << (8 * (exponent - 3))


def target_to_bits(target: int) -> int:
    """Encode a target integer back into compact 'nBits' form."""
    if target == 0:
        return 0
    size = (target.bit_length() + 7) // 8
    if size <= 3:
        mantissa = target << (8 * (3 - size))
    else:
        mantissa = target >> (8 * (size - 3))
    if mantissa & 0x00800000:
        mantissa >>= 8
        size += 1
    return (size << 24) | mantissa


def difficulty_to_target(difficulty: float | int) -> int:
    """Share target for a pool difficulty: diff1_target / difficulty.

    Integer difficulties divide exactly; fractional difficulties (vardiff can
    hand out e.g. 0.5) go through a fixed-point scale so we never touch float
    precision for the high limbs.
    """
    if difficulty <= 0:
        return MAX_TARGET
    if isinstance(difficulty, int) or float(difficulty).is_integer():
        return min(MAX_TARGET, DIFF1_TARGET // int(difficulty))
    scaled = int(round(float(difficulty) * (1 << 32)))
    if scaled <= 0:
        return MAX_TARGET
    return min(MAX_TARGET, (DIFF1_TARGET << 32) // scaled)


def target_to_difficulty(target: int) -> float:
    if target <= 0:
        return float("inf")
    return DIFF1_TARGET / target


def target_to_limbs(target: int) -> np.ndarray:
    """Split a 256-bit target into 8 big-endian uint32 limbs.

    limb[0] is the most significant 32 bits. This is the order the device
    kernels compare in (see ``kernels.sha256_torch.le256``).
    """
    limbs = [(target >> (32 * (7 - i))) & 0xFFFFFFFF for i in range(8)]
    return np.array(limbs, dtype=np.uint32)


def limbs_to_target(limbs) -> int:
    out = 0
    for i, limb in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        out |= int(limb) << (32 * (7 - i))
    return out


def hash_meets_target(digest: bytes, target: int) -> bool:
    """True when a 32-byte digest (as little-endian 256-bit int) <= target."""
    return int.from_bytes(digest, "little") <= target


def difficulty_of_digest(digest: bytes) -> float:
    """The highest difficulty this digest would satisfy (for share-value
    bookkeeping / best-share stats)."""
    value = int.from_bytes(digest, "little")
    if value == 0:
        return float("inf")
    return DIFF1_TARGET / value
