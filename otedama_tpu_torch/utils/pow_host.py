"""Host-side (scalar) proof-of-work digests (counterpart of
``otedama_tpu/utils/pow_host.py``, sha256d and scrypt only).

Every winner a device backend reports is re-hashed here, one header at a
time, before it becomes a share: the card's kernels must agree with these
bit for bit, and the tests hold them to it.
"""

from __future__ import annotations

import hashlib


def sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def scrypt_1024_1_1(data: bytes) -> bytes:
    """Litecoin's proof of work: scrypt with password = salt = the 80-byte
    header, N=1024, r=1, p=1, 32-byte output."""
    return hashlib.scrypt(
        data, salt=data, n=1024, r=1, p=1, maxmem=64 * 1024 * 1024, dklen=32
    )
