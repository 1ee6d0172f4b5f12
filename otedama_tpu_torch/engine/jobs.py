"""Header assembly: coinbase, merkle root, 80-byte header (counterpart of
``otedama_tpu/engine/jobs.py``).

Wire conventions (bitcoin / stratum V1): version, ntime and nbits are
stored little-endian in the header; merkle branch nodes and the merkle
root are in header byte order; the nonce word is the big-endian read of
header bytes 76:80.
"""

from __future__ import annotations

import struct

from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.runtime.search import JobConstants
from otedama_tpu_torch.utils.sha256_host import sha256d


def build_coinbase(job: Job, extranonce2: bytes) -> bytes:
    if len(extranonce2) != job.extranonce2_size:
        raise ValueError(
            f"extranonce2 must be {job.extranonce2_size} bytes, got {len(extranonce2)}"
        )
    return job.coinb1 + job.extranonce1 + extranonce2 + job.coinb2


def merkle_root(coinbase: bytes, branch: list[bytes]) -> bytes:
    """Fold the coinbase txid up the merkle branch (header byte order)."""
    acc = sha256d(coinbase)
    for node in branch:
        acc = sha256d(acc + node)
    return acc


def build_header_prefix(job: Job, extranonce2: bytes, ntime: int | None = None) -> bytes:
    """First 76 bytes of the block header for this (job, extranonce2)."""
    root = merkle_root(build_coinbase(job, extranonce2), job.merkle_branch)
    return (
        struct.pack("<I", job.version)
        + job.prev_hash
        + root
        + struct.pack("<I", ntime if ntime is not None else job.ntime)
        + struct.pack("<I", job.nbits)
    )


def job_constants(job: Job, extranonce2: bytes, ntime: int | None = None) -> JobConstants:
    """Device constants (midstate/tail/target limbs) for one search space."""
    return JobConstants.from_header_prefix(
        build_header_prefix(job, extranonce2, ntime), job.share_target,
        block_number=job.block_number,
    )


def header_from_share(job: Job, extranonce2: bytes, ntime: int, nonce_word: int) -> bytes:
    """The full 80-byte header a share claims to have hashed."""
    return build_header_prefix(job, extranonce2, ntime) + struct.pack(">I", nonce_word)
