"""Job / share / stats data model (counterpart of
``otedama_tpu/engine/types.py``).

Jobs carry the stratum fields (coinbase halves, merkle branch); the engine
derives one header prefix — hence one midstate — per extranonce2 lazily.
"""

from __future__ import annotations

import dataclasses
import enum
import time


class EngineState(enum.Enum):
    IDLE = "idle"
    STARTING = "starting"
    RUNNING = "running"
    STOPPING = "stopping"
    STOPPED = "stopped"
    ERROR = "error"


class ShareOutcome(enum.Enum):
    ACCEPTED = "accepted"
    REJECTED_STALE = "stale"
    REJECTED_DUPLICATE = "duplicate"
    REJECTED_LOW_DIFF = "low-difficulty"
    REJECTED_BAD_JOB = "unknown-job"
    REJECTED_INVALID = "invalid"
    BLOCK_FOUND = "block"


@dataclasses.dataclass
class Job:
    """A unit of work as delivered by a pool (stratum mining.notify) or a
    block template (solo mode)."""

    job_id: str
    prev_hash: bytes            # 32 bytes, header byte order
    coinb1: bytes
    coinb2: bytes
    merkle_branch: list[bytes]  # 32-byte nodes, header byte order
    version: int
    nbits: int
    ntime: int
    clean: bool = False
    algorithm: str = "sha256d"
    # pool-session context needed to build the coinbase
    extranonce1: bytes = b""
    extranonce2_size: int = 4
    # chain height this job mines (templates carry it; stratum V1 does not)
    block_number: int = 0
    # share target for this job (pool difficulty), network target from nbits
    share_target: int = 0
    received_at: float = dataclasses.field(default_factory=time.time)

    def is_expired(self, max_age: float = 120.0) -> bool:
        return time.time() - self.received_at > max_age


@dataclasses.dataclass
class Share:
    """A found share, ready for submission / validation."""

    job_id: str
    worker: str
    extranonce2: bytes
    ntime: int
    nonce_word: int      # big-endian word of header bytes 76:80
    digest: bytes        # 32-byte sha256d of the header
    difficulty: float    # share difficulty actually achieved
    algorithm: str = "sha256d"
    found_at: float = dataclasses.field(default_factory=time.time)

    @property
    def nonce_hex(self) -> str:
        return self.nonce_word.to_bytes(4, "big").hex()

    @property
    def extranonce2_hex(self) -> str:
        return self.extranonce2.hex()


@dataclasses.dataclass
class DeviceStats:
    hashes: int = 0
    shares_found: int = 0
    last_batch_seconds: float = 0.0
    hashrate: float = 0.0  # EMA, H/s

    def record_batch(self, hashes: int, seconds: float, alpha: float = 0.3) -> None:
        self.hashes += hashes
        self.last_batch_seconds = seconds
        if seconds > 0:
            rate = hashes / seconds
            self.hashrate = rate if self.hashrate == 0 else (
                alpha * rate + (1 - alpha) * self.hashrate
            )


@dataclasses.dataclass
class EngineStats:
    started_at: float = dataclasses.field(default_factory=time.time)
    hashes: int = 0
    shares_found: int = 0
    shares_accepted: int = 0
    shares_rejected: int = 0
    shares_stale: int = 0
    blocks_found: int = 0
    best_difficulty: float = 0.0
    current_job_id: str | None = None
    algorithm: str = "sha256d"
    devices: dict[str, DeviceStats] = dataclasses.field(default_factory=dict)

    @property
    def hashrate(self) -> float:
        return sum(d.hashrate for d in self.devices.values())

    @property
    def uptime(self) -> float:
        return time.time() - self.started_at

    def snapshot(self) -> dict:
        return {
            "uptime_seconds": round(self.uptime, 1),
            "hashrate": self.hashrate,
            "hashes": self.hashes,
            "shares": {
                "found": self.shares_found,
                "accepted": self.shares_accepted,
                "rejected": self.shares_rejected,
                "stale": self.shares_stale,
            },
            "blocks_found": self.blocks_found,
            "best_difficulty": self.best_difficulty,
            "current_job": self.current_job_id,
            "algorithm": self.algorithm,
            "devices": {
                k: dataclasses.asdict(v) for k, v in self.devices.items()
            },
        }
