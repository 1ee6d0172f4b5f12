"""Header assembly: coinbase, merkle root, 80-byte header (counterpart of
``otedama_tpu/engine/jobs.py``).

Wire conventions (bitcoin / stratum V1): version, ntime and nbits are
stored little-endian in the header; merkle branch nodes and the merkle
root are in header byte order; the nonce word is the big-endian read of
header bytes 76:80. ``prevhash`` arrives on the stratum wire as 64 hex
characters in word-swapped order (every 4-byte word byte-reversed
against the header); ``decode_prevhash`` undoes it.
"""

from __future__ import annotations

import struct

from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.runtime.search import JobConstants
from otedama_tpu_torch.utils.sha256_host import Sha256Midstate, sha256d


def decode_prevhash(hex_str: str) -> bytes:
    """Stratum prevhash hex -> header byte order (undo per-word reversal)."""
    raw = bytes.fromhex(hex_str)
    if len(raw) != 32:
        raise ValueError("prevhash must be 32 bytes")
    return b"".join(raw[i : i + 4][::-1] for i in range(0, 32, 4))


def encode_prevhash(header_order: bytes) -> str:
    """Header byte order -> stratum prevhash hex (apply per-word reversal)."""
    if len(header_order) != 32:
        raise ValueError("prevhash must be 32 bytes")
    return b"".join(
        header_order[i : i + 4][::-1] for i in range(0, 32, 4)
    ).hex()


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
    """The full 80-byte header a share claims to have hashed. One-shot
    form; the stratum server's per-submit path goes through
    ``ShareAssembler`` (the same bytes, its precompute amortised)."""
    return build_header_prefix(job, extranonce2, ntime) + struct.pack(">I", nonce_word)


class ShareAssembler:
    """Per-(job, extranonce1) precompute for the share-validation path.

    Per (job, session) only extranonce2, ntime and the nonce vary, so the
    rest is frozen once: the sha256 midstate over ``coinb1 ||
    extranonce1`` (each share's coinbase txid is one resumed hash of
    ``extranonce2 || coinb2``) and the packed ``version || prev_hash``
    head and ``nbits`` tail. ``header()`` gives the bytes
    ``header_from_share`` gives on a job carrying the same extranonce
    fields; the tests hold the two to it.
    """

    __slots__ = ("extranonce2_size", "algorithm", "block_number",
                 "_cb_mid", "_coinb2", "_branch", "_head", "_nbits")

    def __init__(self, job: Job, extranonce1: bytes | None = None,
                 extranonce2_size: int | None = None):
        en1 = job.extranonce1 if extranonce1 is None else extranonce1
        self.extranonce2_size = (
            job.extranonce2_size if extranonce2_size is None
            else extranonce2_size
        )
        self.algorithm = job.algorithm
        self.block_number = job.block_number
        self._cb_mid = Sha256Midstate(job.coinb1 + en1)
        self._coinb2 = job.coinb2
        self._branch = list(job.merkle_branch)
        self._head = struct.pack("<I", job.version) + job.prev_hash
        self._nbits = struct.pack("<I", job.nbits)

    def merkle_root(self, extranonce2: bytes) -> bytes:
        if len(extranonce2) != self.extranonce2_size:
            raise ValueError(
                f"extranonce2 must be {self.extranonce2_size} bytes, "
                f"got {len(extranonce2)}"
            )
        acc = self._cb_mid.sha256d_suffix(extranonce2 + self._coinb2)
        for node in self._branch:
            acc = sha256d(acc + node)
        return acc

    def header(self, extranonce2: bytes, ntime: int, nonce_word: int) -> bytes:
        """The same 80 bytes ``header_from_share`` would build."""
        return (
            self._head
            + self.merkle_root(extranonce2)
            + struct.pack("<I", ntime)
            + self._nbits
            + struct.pack(">I", nonce_word)
        )
