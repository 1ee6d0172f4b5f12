"""Nonce-space partitioning (counterpart of
``otedama_tpu/runtime/partition.py``).

Within one header the 2^32 nonce space is consumed in launch-sized
strides; exhausting it rolls extranonce2, which changes the coinbase,
hence the merkle root and the whole header.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

NONCE_SPACE = 1 << 32


@dataclasses.dataclass(frozen=True)
class NonceRange:
    """A half-open range [start, start+count) in the uint32 nonce space."""

    start: int
    count: int

    def batches(self, batch: int) -> Iterator[tuple[int, int]]:
        """Yield (base, n) strides of at most ``batch`` nonces."""
        off = self.start
        remaining = self.count
        while remaining > 0:
            n = min(batch, remaining)
            yield off & 0xFFFFFFFF, n
            off += n
            remaining -= n


@dataclasses.dataclass
class ExtranonceCounter:
    """Rolls extranonce2 values for a worker; each value opens a fresh
    2^32 nonce space. ``size`` is the extranonce2 byte width."""

    size: int = 4
    value: int = 0

    def current(self) -> bytes:
        return self.value.to_bytes(self.size, "big")

    def roll(self) -> bytes:
        self.value = (self.value + 1) % (1 << (8 * self.size))
        return self.current()
