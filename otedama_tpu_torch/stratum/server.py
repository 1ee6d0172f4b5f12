"""What the stratum server hands the pool (counterpart of the share types of
``otedama_tpu/stratum/server.py``: ``AcceptedShare``, ``ShareHook``,
``BlockHook``). The server itself, with the stratum client and the pool
modes, comes with ROADMAP A6; the pool ledger (``pool/manager.py``) takes
these shares today.
"""

from __future__ import annotations

import dataclasses
from typing import Awaitable, Callable

from otedama_tpu_torch.engine.types import Job


@dataclasses.dataclass
class AcceptedShare:
    """What the pool backend receives for every accepted share."""

    session_id: int
    worker_user: str
    job_id: str
    difficulty: float        # difficulty credited (session difficulty at job time)
    actual_difficulty: float # difficulty the digest actually achieved
    digest: bytes
    header: bytes            # the 80-byte header the share hashed
    extranonce2: bytes       # as submitted by the miner
    ntime: int
    nonce_word: int
    is_block: bool
    submitted_at: float
    # the job's algorithm and chain height, carried so downstream batch
    # consumers (device re-validation) never re-derive them
    algorithm: str = "sha256d"
    block_number: int = 0
    # the session's extranonce1 lease: with coinb1/coinb2 + extranonce2
    # it rebuilds the exact coinbase bytes this share hashed
    extranonce1: bytes = b""


ShareHook = Callable[[AcceptedShare], Awaitable[None]]
BlockHook = Callable[[bytes, Job, AcceptedShare], Awaitable[None]]
