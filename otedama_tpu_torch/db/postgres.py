"""PostgreSQL persistence backend behind the SQLite Database's surface
(counterpart of ``otedama_tpu/db/postgres.py``, copied whole).

``connect_database`` (db.database) selects this backend for
``postgres://`` and ``postgresql://`` URLs; everything above the
Database surface — the repositories in db/repos.py and the pool
manager — is dialect-blind and runs unchanged.

Drivers, in preference order: ``psycopg`` (v3), ``psycopg2``, then the
vendored pure-python wire driver (db/pgwire.py), so a postgres:// URL
works with no installation at all (SCRAM-authenticated servers still
need psycopg). The tests run this tier over the real v3 wire protocol
against a loopback emulator (tests/pg_emulator.py).

Dialect mapping (one shared MIGRATIONS list, translated):
- ``?`` placeholders        -> ``%s`` (DB-API paramstyle)
- INTEGER PRIMARY KEY AUTOINCREMENT -> BIGSERIAL PRIMARY KEY
- REAL                      -> DOUBLE PRECISION
- PRAGMA user_version       -> a schema_migrations table
- cursor.lastrowid          -> INSERT ... RETURNING id
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading
import time

from otedama_tpu_torch.db.database import MIGRATIONS, AuditMixin, split_statements

log = logging.getLogger("otedama.db.postgres")


def translate_sql(sql: str) -> str:
    """sqlite ``?`` placeholders -> DB-API ``%s`` (none of this schema's
    SQL carries a literal question mark)."""
    return sql.replace("?", "%s")


def translate_ddl(sql: str) -> str:
    """sqlite DDL dialect -> postgres."""
    out = sql.replace(
        "INTEGER PRIMARY KEY AUTOINCREMENT", "BIGSERIAL PRIMARY KEY"
    )
    out = re.sub(r"\bREAL\b", "DOUBLE PRECISION", out)
    return out


def _load_driver():
    """psycopg (v3) preferred, psycopg2 accepted, and the VENDORED pure-
    python wire driver (db/pgwire.py) as the always-available fallback —
    a postgres:// URL works out of the box (SCRAM-auth servers still
    need psycopg; pgwire says so in its error)."""
    try:
        import psycopg
        import psycopg.rows  # noqa: F401 - explicit: dict_row is used

        return "psycopg3", psycopg
    except ImportError:
        pass
    try:
        import psycopg2
        import psycopg2.extras

        return "psycopg2", psycopg2
    except ImportError:
        pass
    from otedama_tpu_torch.db import pgwire

    log.warning(
        "psycopg not installed: using the vendored pure-python pgwire "
        "driver (no TLS, no SCRAM; fine for trusted networks — install "
        "psycopg for production deployments)"
    )
    return "pgwire", pgwire


@dataclasses.dataclass
class _Result:
    """The cursor-shaped slice of DB-API the repositories actually use."""

    lastrowid: int | None
    rowcount: int


class PostgresDatabase(AuditMixin):
    """Thread-safe psycopg wrapper with the sqlite Database's surface."""

    def __init__(self, dsn: str):
        self._kind, self._driver = _load_driver()
        self.path = dsn
        self._lock = threading.RLock()
        if self._kind == "psycopg3":
            self._conn = self._driver.connect(
                dsn, autocommit=True,
                row_factory=self._driver.rows.dict_row,
            )
        else:
            # psycopg2 and pgwire share the classic DB-API shape
            self._conn = self._driver.connect(dsn)
            self._conn.autocommit = True
        self.migrate()

    def _cursor(self):
        if self._kind == "psycopg3":
            return self._conn.cursor()
        if self._kind == "pgwire":
            return self._conn.cursor()  # dict rows natively
        return self._conn.cursor(
            cursor_factory=self._driver.extras.RealDictCursor
        )

    # -- migrations ---------------------------------------------------------

    # app-scoped advisory lock key: concurrent replicas starting against
    # one database must serialize the check-and-apply sequence (sqlite
    # never had this problem: one file, one process)
    _MIGRATE_LOCK_KEY = 0x07EDA3A0

    def schema_version(self) -> int:
        with self._lock, self._cursor() as cur:
            cur.execute(
                "CREATE TABLE IF NOT EXISTS schema_migrations ("
                "version INTEGER PRIMARY KEY, applied_at DOUBLE PRECISION)"
            )
            cur.execute("SELECT MAX(version) AS v FROM schema_migrations")
            row = cur.fetchone()
            return int(row["v"] or 0)

    def migrate(self) -> None:
        with self._lock:
            with self._cursor() as cur:
                cur.execute("SELECT pg_advisory_lock(%s)",
                            (self._MIGRATE_LOCK_KEY,))
            try:
                # version read must happen INSIDE the advisory lock: a
                # concurrent replica may have just applied everything
                current = self.schema_version()
                for version, sql in MIGRATIONS:
                    if version <= current:
                        continue
                    log.info("applying postgres migration %d", version)
                    with self._cursor() as cur:
                        cur.execute("BEGIN")
                        try:
                            for stmt in split_statements(
                                    translate_ddl(sql)):
                                cur.execute(stmt)
                            cur.execute(
                                "INSERT INTO schema_migrations "
                                "VALUES (%s, %s)",
                                (version, time.time()),
                            )
                            cur.execute("COMMIT")
                        except Exception:
                            cur.execute("ROLLBACK")
                            raise
            finally:
                with self._cursor() as cur:
                    cur.execute("SELECT pg_advisory_unlock(%s)",
                                (self._MIGRATE_LOCK_KEY,))

    # -- access -------------------------------------------------------------

    def execute(self, sql: str, params: tuple = ()) -> _Result:
        s = translate_sql(sql)
        returning = (
            s.lstrip()[:6].upper() == "INSERT" and "RETURNING" not in s.upper()
        )
        with self._lock, self._cursor() as cur:
            if returning:
                # every table carries a BIGSERIAL id; this replaces the
                # sqlite cursor.lastrowid the repositories rely on
                cur.execute(s + " RETURNING id", params)
                row = cur.fetchone()
                return _Result(int(row["id"]) if row else None, cur.rowcount)
            cur.execute(s, params)
            return _Result(None, cur.rowcount)

    def executemany(self, sql: str, rows: list[tuple]) -> _Result:
        with self._lock, self._cursor() as cur:
            cur.executemany(translate_sql(sql), rows)
            return _Result(None, cur.rowcount)

    def query(self, sql: str, params: tuple = ()) -> list[dict]:
        with self._lock, self._cursor() as cur:
            cur.execute(translate_sql(sql), params)
            return list(cur.fetchall())

    def query_one(self, sql: str, params: tuple = ()) -> dict | None:
        with self._lock, self._cursor() as cur:
            cur.execute(translate_sql(sql), params)
            return cur.fetchone()

    def transaction(self):
        return _PgTransaction(self)

    # -- savepoints (group-commit ledger; sqlite Database parity) ------------

    def savepoint(self, name: str) -> None:
        with self._lock, self._cursor() as cur:
            cur.execute(f"SAVEPOINT {name}")

    def release(self, name: str) -> None:
        with self._lock, self._cursor() as cur:
            cur.execute(f"RELEASE SAVEPOINT {name}")

    def rollback_to(self, name: str) -> None:
        with self._lock, self._cursor() as cur:
            cur.execute(f"ROLLBACK TO SAVEPOINT {name}")
            cur.execute(f"RELEASE SAVEPOINT {name}")

    # audit()/query_audit() come from AuditMixin — execute/query translate
    # the placeholders, so the SQL stays shared with the sqlite backend

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class _PgTransaction:
    """BEGIN/COMMIT/ROLLBACK under the db lock — mirror of the sqlite
    backend's _Transaction so `with db.transaction():` is portable."""

    def __init__(self, db: PostgresDatabase):
        self.db = db

    def __enter__(self):
        self.db._lock.acquire()
        self._cur = self.db._cursor()
        self._cur.execute("BEGIN")
        return self.db

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self._cur.execute("COMMIT")
            else:
                self._cur.execute("ROLLBACK")
            self._cur.close()
        finally:
            self.db._lock.release()
