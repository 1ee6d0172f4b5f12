"""SQLite persistence manager and the backend-selection factory
(counterpart of ``otedama_tpu/db/database.py``).

stdlib sqlite3 in WAL mode with a single writer thread affinity, versioned
migrations applied transactionally (the reference's schema, so a database
file is shared between the packages), ``:memory:`` supported for tests.
``connect_database`` routes ``postgres://`` URLs to the PostgreSQL
backend (db/postgres.py) behind the identical surface.
"""

from __future__ import annotations

import logging
import re
import sqlite3
import threading
import time

from otedama_tpu_torch.utils import faults

log = logging.getLogger("otedama.db")


def split_statements(script: str) -> list[str]:
    """Split a multi-statement SQL script on ``;`` — but never inside a
    single-quoted literal or a dollar-quoted body ($$...$$ / $tag$...),
    so a migration carrying either cannot be mis-split. Shared by the
    sqlite and postgres migrate() paths (sqlite never
    emits dollar quotes; treating them as quotes is harmless for this
    schema's DDL). Returns non-empty statements, quotes left intact."""
    stmts: list[str] = []
    buf: list[str] = []
    i, n = 0, len(script)
    dollar_tag: str | None = None
    body_start = 0  # first index past the opening tag (close must not overlap)
    in_squote = False
    while i < n:
        ch = script[i]
        if dollar_tag is not None:
            buf.append(ch)
            if (ch == "$"
                    and i - len(dollar_tag) + 1 >= body_start
                    and script[i - len(dollar_tag) + 1:i + 1] == dollar_tag):
                dollar_tag = None
            i += 1
            continue
        if in_squote:
            buf.append(ch)
            if ch == "'":
                # '' is an escaped quote, stay inside the literal
                if i + 1 < n and script[i + 1] == "'":
                    buf.append("'")
                    i += 1
                else:
                    in_squote = False
            i += 1
            continue
        if ch == "-" and script[i:i + 2] == "--":
            # -- line comment: an apostrophe in it must not flip quote
            # state (MIGRATIONS carry such comments today)
            end = script.find("\n", i)
            end = n if end == -1 else end
            buf.append(script[i:end])
            i = end
            continue
        if ch == "/" and script[i:i + 2] == "/*":
            end = script.find("*/", i + 2)
            end = n if end == -1 else end + 2
            buf.append(script[i:end])
            i = end
            continue
        if ch == "'":
            in_squote = True
            buf.append(ch)
        elif ch == "$":
            # postgres tag rule: empty ($$) or letter/underscore first,
            # then letters/digits/underscores
            m = re.match(r"\$(?:[A-Za-z_][A-Za-z0-9_]*)?\$", script[i:])
            if m:
                dollar_tag = m.group(0)
                buf.append(dollar_tag)
                i += len(dollar_tag)
                body_start = i
                continue
            buf.append(ch)
        elif ch == ";":
            stmt = "".join(buf).strip()
            if stmt:
                stmts.append(stmt)
            buf = []
        else:
            buf.append(ch)
        i += 1
    tail = "".join(buf).strip()
    if tail:
        stmts.append(tail)
    return stmts


MIGRATIONS: list[tuple[int, str]] = [
    (1, """
    CREATE TABLE workers (
        id          INTEGER PRIMARY KEY AUTOINCREMENT,
        name        TEXT NOT NULL UNIQUE,
        wallet      TEXT NOT NULL DEFAULT '',
        created_at  REAL NOT NULL,
        last_seen   REAL NOT NULL,
        hashrate    REAL NOT NULL DEFAULT 0,
        shares_valid   INTEGER NOT NULL DEFAULT 0,
        shares_invalid INTEGER NOT NULL DEFAULT 0,
        balance     INTEGER NOT NULL DEFAULT 0,      -- atomic units
        paid_total  INTEGER NOT NULL DEFAULT 0,
        metadata    TEXT NOT NULL DEFAULT '{}'
    );
    CREATE TABLE shares (
        id          INTEGER PRIMARY KEY AUTOINCREMENT,
        worker      TEXT NOT NULL,
        job_id      TEXT NOT NULL,
        difficulty  REAL NOT NULL,
        actual_difficulty REAL NOT NULL DEFAULT 0,
        is_block    INTEGER NOT NULL DEFAULT 0,
        created_at  REAL NOT NULL
    );
    CREATE INDEX idx_shares_worker_time ON shares(worker, created_at);
    CREATE INDEX idx_shares_time ON shares(created_at);
    CREATE TABLE blocks (
        id          INTEGER PRIMARY KEY AUTOINCREMENT,
        height      INTEGER NOT NULL DEFAULT 0,
        hash        TEXT NOT NULL,
        worker      TEXT NOT NULL,
        reward      INTEGER NOT NULL DEFAULT 0,
        status      TEXT NOT NULL DEFAULT 'pending', -- pending|confirmed|orphaned
        confirmations INTEGER NOT NULL DEFAULT 0,
        created_at  REAL NOT NULL
    );
    CREATE TABLE payouts (
        id          INTEGER PRIMARY KEY AUTOINCREMENT,
        worker      TEXT NOT NULL,
        address     TEXT NOT NULL,
        amount      INTEGER NOT NULL,
        tx_id       TEXT NOT NULL DEFAULT '',
        status      TEXT NOT NULL DEFAULT 'pending', -- pending|sent|confirmed|failed
        created_at  REAL NOT NULL,
        sent_at     REAL
    );
    CREATE INDEX idx_payouts_worker ON payouts(worker);
    """),
    (2, """
    CREATE TABLE audit_log (
        id         INTEGER PRIMARY KEY AUTOINCREMENT,
        actor      TEXT NOT NULL,
        action     TEXT NOT NULL,
        detail     TEXT NOT NULL DEFAULT '',
        created_at REAL NOT NULL
    );
    """),
    # settlement ledger (pool/settlement.py): append-only, idempotency-
    # keyed. `skey` columns are deterministic ids derived from the share-
    # chain snapshot tip (+ worker for payout_txs) so a replayed
    # settlement writes the SAME rows it wrote before the crash — the
    # UNIQUE constraints are the hard duplicate-payment backstop.
    (3, """
    ALTER TABLE blocks ADD COLUMN settled_skey TEXT NOT NULL DEFAULT '';
    CREATE TABLE settlements (
        id           INTEGER PRIMARY KEY AUTOINCREMENT,
        skey         TEXT NOT NULL UNIQUE,   -- H(tag | snapshot tip id)
        tip_hash     TEXT NOT NULL,          -- snapshot tip share id (hex)
        tip_height   INTEGER NOT NULL,       -- chain position AFTER the tip
        start_height INTEGER NOT NULL,       -- first chain position consumed
        reward       INTEGER NOT NULL,
        pool_fee     INTEGER NOT NULL,
        state        TEXT NOT NULL DEFAULT 'calculated',
                     -- calculated -> credited -> submitting -> settled
        created_at   REAL NOT NULL,
        settled_at   REAL
    );
    CREATE INDEX idx_settlements_state ON settlements(state);
    CREATE TABLE settlement_credits (
        settlement_skey TEXT NOT NULL,
        worker          TEXT NOT NULL,
        amount          INTEGER NOT NULL,    -- atomic units
        share_value     REAL NOT NULL,
        applied_at      REAL,
        PRIMARY KEY (settlement_skey, worker)
    );
    CREATE TABLE payout_txs (
        id              INTEGER PRIMARY KEY AUTOINCREMENT,
        skey            TEXT NOT NULL UNIQUE, -- H(tag | tip id | worker)
        settlement_skey TEXT NOT NULL,
        worker          TEXT NOT NULL,
        address         TEXT NOT NULL,
        amount          INTEGER NOT NULL,     -- net of fee
        fee             INTEGER NOT NULL,
        status          TEXT NOT NULL DEFAULT 'pending', -- pending|sent|failed
        tx_ref          TEXT NOT NULL DEFAULT '',
        created_at      REAL NOT NULL,
        sent_at         REAL
    );
    CREATE INDEX idx_payout_txs_settlement ON payout_txs(settlement_skey);
    CREATE INDEX idx_payout_txs_worker ON payout_txs(worker);
    CREATE INDEX idx_payout_txs_status ON payout_txs(status);
    """),
    # merged mining (otedama_tpu/work): block rows are chain-tagged so
    # the parent submitter and each aux chain's confirmation sweep poll
    # ONLY their own node (a parent reorg must never orphan an aux row),
    # while settlement keeps consuming ONE unsettled_confirmed() stream
    # across every chain — per-chain splits derive from the same rows.
    (4, """
    ALTER TABLE blocks ADD COLUMN chain TEXT NOT NULL DEFAULT 'parent';
    CREATE INDEX idx_blocks_chain_status ON blocks(chain, status);
    """),
]


class AuditMixin:
    """Audit-trail read/write over the shared execute/query surface: one
    definition for both backends (each translates placeholders in its
    own execute/query)."""

    def audit(self, actor: str, action: str, detail: str = "") -> None:
        self.execute(
            "INSERT INTO audit_log (actor, action, detail, created_at) "
            "VALUES (?,?,?,?)",
            (actor, action, detail, time.time()),
        )

    def query_audit(self, actor: str | None = None, action: str | None = None,
                    limit: int = 100) -> list[dict]:
        """Filtered audit-trail read, newest first."""
        sql = "SELECT actor, action, detail, created_at FROM audit_log"
        conds: list[str] = []
        params: list = []
        if actor:
            conds.append("actor = ?")
            params.append(actor)
        if action:
            conds.append("action = ?")
            params.append(action)
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        sql += " ORDER BY created_at DESC, id DESC LIMIT ?"
        params.append(int(limit))
        return [dict(r) for r in self.query(sql, tuple(params))]


class Database(AuditMixin):
    """Thread-safe sqlite3 wrapper with schema migrations."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._lock = threading.RLock()
        # write accounting: chaos runs and the settlement engine read
        # these to prove failures were SEEN, not swallowed (injected
        # db.execute faults count here alongside real sqlite errors)
        self.writes = 0
        self.write_failures = 0
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        self._conn.row_factory = sqlite3.Row
        self.journal_mode = str(
            self._conn.execute("PRAGMA journal_mode=WAL").fetchone()[0]
        ).lower()
        if path != ":memory:" and self.journal_mode != "wal":
            # the settlement ledger's crash-safety story assumes WAL
            # (atomic multi-statement commits survive a mid-write kill);
            # a filesystem that silently refused it must fail loudly
            raise RuntimeError(
                f"sqlite at {path!r} could not enter WAL journal mode "
                f"(got {self.journal_mode!r}); the ledger requires it"
            )
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self.migrate()

    # -- migrations ---------------------------------------------------------

    def schema_version(self) -> int:
        with self._lock:
            return int(self._conn.execute("PRAGMA user_version").fetchone()[0])

    def migrate(self) -> None:
        with self._lock:
            current = self.schema_version()
            for version, sql in MIGRATIONS:
                if version <= current:
                    continue
                log.info("applying migration %d", version)
                # NB: executescript() would implicitly commit, so split and
                # run the statements inside one explicit transaction
                self._conn.execute("BEGIN")
                try:
                    for stmt in split_statements(sql):
                        self._conn.execute(stmt)
                    self._conn.execute(f"PRAGMA user_version = {version}")
                    self._conn.execute("COMMIT")
                except Exception:
                    self._conn.execute("ROLLBACK")
                    raise

    # -- access -------------------------------------------------------------

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        # fault point db.execute: injected errors/delays hit application
        # statements only — migration DDL and transaction control (BEGIN/
        # COMMIT/ROLLBACK in migrate()/_Transaction) bypass this method,
        # so an injected write failure always leaves a rollbackable txn
        try:
            d = faults.hit("db.execute", supports=faults.POINT)
        except Exception:
            with self._lock:
                self.write_failures += 1
            raise
        if d is not None:
            d.sleep_sync()
        with self._lock:
            self.writes += 1
            try:
                return self._conn.execute(sql, params)
            except Exception:
                self.write_failures += 1
                raise

    def executemany(self, sql: str, rows: list[tuple]) -> sqlite3.Cursor:
        try:
            d = faults.hit("db.execute", supports=faults.POINT)
        except Exception:
            with self._lock:
                self.write_failures += 1
            raise
        if d is not None:
            d.sleep_sync()
        with self._lock:
            self.writes += 1
            try:
                return self._conn.executemany(sql, rows)
            except Exception:
                self.write_failures += 1
                raise

    def query(self, sql: str, params: tuple = ()) -> list[sqlite3.Row]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def query_one(self, sql: str, params: tuple = ()) -> sqlite3.Row | None:
        with self._lock:
            return self._conn.execute(sql, params).fetchone()

    def transaction(self):
        return _Transaction(self)

    # -- savepoints (group-commit ledger) ------------------------------------
    # Like BEGIN/COMMIT/ROLLBACK these are transaction CONTROL and
    # bypass the db.execute fault point: an injected statement failure
    # inside a savepoint must always leave a rollbackable scope, and a
    # fault firing on the rollback itself would wedge the batch.

    def savepoint(self, name: str) -> None:
        with self._lock:
            self._conn.execute(f"SAVEPOINT {name}")

    def release(self, name: str) -> None:
        with self._lock:
            self._conn.execute(f"RELEASE SAVEPOINT {name}")

    def rollback_to(self, name: str) -> None:
        """Rolls back the savepoint's effects AND releases it (plain
        ROLLBACK TO keeps the savepoint on the stack)."""
        with self._lock:
            self._conn.execute(f"ROLLBACK TO SAVEPOINT {name}")
            self._conn.execute(f"RELEASE SAVEPOINT {name}")

    def snapshot(self) -> dict:
        """Write-path health for operator surfaces (settlement snapshot,
        chaos runs): every executed statement and every failure, injected
        or real, is visible here."""
        with self._lock:
            return {
                "path": self.path,
                "journal_mode": self.journal_mode,
                "writes": self.writes,
                "write_failures": self.write_failures,
            }

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class _Transaction:
    def __init__(self, db: Database):
        self.db = db

    def __enter__(self):
        self.db._lock.acquire()
        # IMMEDIATE: take the write lock at BEGIN, not at first write —
        # a ledger batch commit must never discover mid-transaction that
        # another connection (backup tooling, operator sqlite3 shell)
        # holds the file, because a late SQLITE_BUSY aborts the batch
        self.db._conn.execute("BEGIN IMMEDIATE")
        return self.db

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.db._conn.execute("COMMIT")
            else:
                self.db._conn.execute("ROLLBACK")
        finally:
            self.db._lock.release()
        return False


def connect_database(url: str):
    """Backend selection by URL: ``postgres://`` / ``postgresql://`` DSNs
    get the PostgreSQL backend (db/postgres.py); ``sqlite:///path`` and
    bare paths (including ``:memory:``) get SQLite. Any other
    ``scheme://`` fails loudly — a typo'd or unsupported DSN must not
    silently become a throwaway SQLite file named after the URL."""
    if "://" in url:
        scheme = url.split("://", 1)[0].lower()
        if scheme in ("postgres", "postgresql"):
            from otedama_tpu_torch.db.postgres import PostgresDatabase

            return PostgresDatabase(url)
        if scheme == "sqlite":
            # sqlite:///absolute/path or sqlite://relative/path
            path = url.split("://", 1)[1]
            return Database(path or ":memory:")
        raise ValueError(
            f"unsupported database scheme {scheme!r} in {url!r} "
            "(supported: a sqlite path, sqlite://, postgres://)"
        )
    return Database(url)
