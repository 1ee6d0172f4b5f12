"""Persistence: SQLite or PostgreSQL through ``connect_database`` and the
repositories the pool ledger writes (counterpart of ``otedama_tpu/db``)."""

from otedama_tpu_torch.db.database import Database, connect_database
from otedama_tpu_torch.db.repos import (
    BlockRepository,
    PayoutRepository,
    ShareRepository,
    WorkerRepository,
)

__all__ = [
    "Database",
    "connect_database",
    "WorkerRepository",
    "ShareRepository",
    "BlockRepository",
    "PayoutRepository",
]
