"""Repositories over the SQLite schema (counterpart of
``otedama_tpu/db/repos.py``: the worker, share, block and payout
repositories; the settlement ledger's come with settlement).

Reference parity: internal/database/{worker,share,block,payout}_repository.go.
Same responsibilities; amounts are integer atomic units (satoshi-style) to
avoid float drift in balances, matching the reference's big.Int usage.
"""

from __future__ import annotations

import json
import time

from otedama_tpu_torch.db.database import Database


class WorkerRepository:
    def __init__(self, db: Database):
        self.db = db

    def upsert(self, name: str, wallet: str = "", metadata: dict | None = None) -> None:
        now = time.time()
        self.db.execute(
            """INSERT INTO workers (name, wallet, created_at, last_seen, metadata)
               VALUES (?,?,?,?,?)
               ON CONFLICT(name) DO UPDATE SET
                 wallet = CASE WHEN excluded.wallet != '' THEN excluded.wallet ELSE workers.wallet END,
                 last_seen = excluded.last_seen""",
            (name, wallet, now, now, json.dumps(metadata or {})),
        )

    def touch(self, name: str, hashrate: float | None = None) -> None:
        if hashrate is None:
            self.db.execute(
                "UPDATE workers SET last_seen=? WHERE name=?", (time.time(), name)
            )
        else:
            self.db.execute(
                "UPDATE workers SET last_seen=?, hashrate=? WHERE name=?",
                (time.time(), hashrate, name),
            )

    def record_share(self, name: str, valid: bool) -> None:
        col = "shares_valid" if valid else "shares_invalid"
        self.db.execute(
            f"UPDATE workers SET {col} = {col} + 1, last_seen=? WHERE name=?",
            (time.time(), name),
        )

    def credit(self, name: str, amount: int) -> None:
        self.db.execute(
            "UPDATE workers SET balance = balance + ? WHERE name=?", (amount, name)
        )

    def upsert_many(self, names: list[str]) -> None:
        """Batch upsert (block distribution touches every worker in the
        payout window: one executemany, not N round-trips)."""
        now = time.time()
        self.db.executemany(
            """INSERT INTO workers (name, wallet, created_at, last_seen, metadata)
               VALUES (?,?,?,?,?)
               ON CONFLICT(name) DO UPDATE SET last_seen = excluded.last_seen""",
            [(name, "", now, now, "{}") for name in names],
        )

    def credit_many(self, pairs: list[tuple[str, int]]) -> None:
        """Batch credit: (name, amount) rows in one statement."""
        self.db.executemany(
            "UPDATE workers SET balance = balance + ? WHERE name=?",
            [(amount, name) for name, amount in pairs],
        )

    def record_shares_many(self, counts: list[tuple[str, int]]) -> None:
        """Batch share-count bump: (name, valid_count) rows in one
        statement (the group-commit ledger aggregates a batch's shares
        per worker before touching the table)."""
        now = time.time()
        self.db.executemany(
            "UPDATE workers SET shares_valid = shares_valid + ?, "
            "last_seen=? WHERE name=?",
            [(n, now, name) for name, n in counts],
        )

    def debit_for_payout(self, name: str, amount: int) -> None:
        self.db.execute(
            "UPDATE workers SET balance = balance - ?, paid_total = paid_total + ? WHERE name=?",
            (amount, amount, name),
        )

    def get(self, name: str) -> dict | None:
        row = self.db.query_one("SELECT * FROM workers WHERE name=?", (name,))
        return dict(row) if row else None

    def list(self, active_within: float | None = None) -> list[dict]:
        if active_within is None:
            rows = self.db.query("SELECT * FROM workers ORDER BY name")
        else:
            rows = self.db.query(
                "SELECT * FROM workers WHERE last_seen >= ? ORDER BY name",
                (time.time() - active_within,),
            )
        return [dict(r) for r in rows]


class ShareRepository:
    def __init__(self, db: Database):
        self.db = db

    def create(
        self,
        worker: str,
        job_id: str,
        difficulty: float,
        actual_difficulty: float = 0.0,
        is_block: bool = False,
        created_at: float | None = None,
    ) -> int:
        cur = self.db.execute(
            """INSERT INTO shares (worker, job_id, difficulty, actual_difficulty,
               is_block, created_at) VALUES (?,?,?,?,?,?)""",
            (
                worker, job_id, difficulty, actual_difficulty,
                int(is_block), created_at if created_at is not None else time.time(),
            ),
        )
        return cur.lastrowid

    def create_many(self, rows: list[tuple]) -> None:
        """(worker, job_id, difficulty, actual_difficulty, is_block,
        created_at) rows in one statement — the group-commit ledger's
        per-batch share insert."""
        self.db.executemany(
            """INSERT INTO shares (worker, job_id, difficulty,
               actual_difficulty, is_block, created_at)
               VALUES (?,?,?,?,?,?)""",
            [(w, j, d, a, int(b), t) for w, j, d, a, b, t in rows],
        )

    def last_n(self, n: int) -> list[dict]:
        """The PPLNS window: most recent ``n`` shares, oldest first."""
        rows = self.db.query(
            "SELECT * FROM shares ORDER BY id DESC LIMIT ?", (n,)
        )
        return [dict(r) for r in reversed(rows)]

    def since(self, t: float) -> list[dict]:
        rows = self.db.query(
            "SELECT * FROM shares WHERE created_at >= ? ORDER BY id", (t,)
        )
        return [dict(r) for r in rows]

    def count(self) -> int:
        return int(self.db.query_one("SELECT COUNT(*) c FROM shares")["c"])

    def prune_before(self, t: float) -> int:
        cur = self.db.execute("DELETE FROM shares WHERE created_at < ?", (t,))
        return cur.rowcount


class BlockRepository:
    def __init__(self, db: Database):
        self.db = db

    def create(self, block_hash: str, worker: str, height: int = 0,
               reward: int = 0, chain: str = "parent") -> int:
        cur = self.db.execute(
            """INSERT INTO blocks (height, hash, worker, reward, chain,
                                   created_at)
               VALUES (?,?,?,?,?,?)""",
            (height, block_hash, worker, reward, chain, time.time()),
        )
        return cur.lastrowid

    def set_status(self, block_hash: str, status: str, confirmations: int = 0) -> None:
        self.db.execute(
            "UPDATE blocks SET status=?, confirmations=? WHERE hash=?",
            (status, confirmations, block_hash),
        )

    def pending(self, chain: str | None = None) -> list[dict]:
        """Pending rows, optionally one chain's — each chain's
        confirmation sweep must poll only its own node."""
        if chain is None:
            return [dict(r) for r in self.db.query(
                "SELECT * FROM blocks WHERE status='pending' ORDER BY id"
            )]
        return [dict(r) for r in self.db.query(
            "SELECT * FROM blocks WHERE status='pending' AND chain=? "
            "ORDER BY id", (chain,)
        )]

    def list(self, limit: int = 100) -> list[dict]:
        return [dict(r) for r in self.db.query(
            "SELECT * FROM blocks ORDER BY id DESC LIMIT ?", (limit,)
        )]


class PayoutRepository:
    def __init__(self, db: Database):
        self.db = db

    def create(self, worker: str, address: str, amount: int) -> int:
        cur = self.db.execute(
            "INSERT INTO payouts (worker, address, amount, created_at) VALUES (?,?,?,?)",
            (worker, address, amount, time.time()),
        )
        return cur.lastrowid

    def mark_sent(self, payout_id: int, tx_id: str) -> None:
        self.db.execute(
            "UPDATE payouts SET status='sent', tx_id=?, sent_at=? WHERE id=?",
            (tx_id, time.time(), payout_id),
        )

    def mark_failed(self, payout_id: int) -> None:
        self.db.execute(
            "UPDATE payouts SET status='failed' WHERE id=?", (payout_id,)
        )

    def pending(self) -> list[dict]:
        return [dict(r) for r in self.db.query(
            "SELECT * FROM payouts WHERE status='pending' ORDER BY id"
        )]

    def for_worker(self, worker: str, limit: int = 100) -> list[dict]:
        return [dict(r) for r in self.db.query(
            "SELECT * FROM payouts WHERE worker=? ORDER BY id DESC LIMIT ?",
            (worker, limit),
        )]
