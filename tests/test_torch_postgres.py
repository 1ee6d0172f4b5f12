"""Port parity, the PostgreSQL books: ``tests/test_postgres.py``'s cases
through both packages (parametrised ``jax`` / ``torch``: the JAX
package's ``db`` modules and the port's), on the CPU.

- the dialect translation (``translate_sql``, ``translate_ddl``) gives
  equal output over the shared ``MIGRATIONS``, and ``split_statements``,
  ``pgwire.interpolate`` and ``pgwire.escape_literal`` agree on
  numpy-seeded values;
- both vendored drivers speak the v3 wire protocol to the loopback
  emulator (``tests/pg_emulator.py``), the refusal when the server
  reports ``standard_conforming_strings`` off included;
- the whole PostgreSQL tier (migrations, repositories, transactions,
  audit) runs over the wire in each package, and one
  ``PoolManager.on_share_batch`` ledger run books the same rows through
  each package's ``PostgresDatabase``.

``OTEDAMA_TEST_PG_DSN`` points the live case at a real server instead
of the emulator.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import socket
import struct
import time
import types

import numpy as np
import pytest

from tests import pg_emulator

PG_DSN = os.environ.get("OTEDAMA_TEST_PG_DSN", "")
PACKAGES = {"jax": "otedama_tpu", "torch": "otedama_tpu_torch"}


def _package(name: str) -> types.SimpleNamespace:
    root = PACKAGES[name]
    mods = {m: importlib.import_module(f"{root}.{m}") for m in (
        "db", "db.database", "db.postgres", "db.pgwire", "pool.manager",
        "pool.payouts", "pool.blockchain", "stratum.server")}
    return types.SimpleNamespace(
        db=mods["db"], database=mods["db.database"],
        postgres=mods["db.postgres"], pgwire=mods["db.pgwire"],
        manager=mods["pool.manager"], payouts=mods["pool.payouts"],
        chain=mods["pool.blockchain"], server=mods["stratum.server"])


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return _package(request.param)


@pytest.fixture
def pgwire_only(pkg, monkeypatch):
    """Pin the vendored driver: psycopg, where installed, speaks an
    extended protocol the simple-protocol emulator does not."""
    monkeypatch.setattr(pkg.postgres, "_load_driver",
                        lambda: ("pgwire", pkg.pgwire))
    return pkg


class PgEmulator(pg_emulator.PgEmulator):
    """The loopback emulator with TCP_NODELAY on its accepted sockets, as
    a PostgreSQL backend sets it: the emulator writes CommandComplete and
    ReadyForQuery as two segments, and without it Nagle holds the second
    behind the client's delayed ACK (~40 ms a statement)."""

    def _serve(self, sock):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        super()._serve(sock)


def _have_driver() -> bool:
    for name in ("psycopg", "psycopg2"):
        try:
            importlib.import_module(name)
            return True
        except ImportError:
            pass
    return False


# -- dialect translation (no server needed) ----------------------------------

def test_placeholder_translation(pkg):
    assert pkg.postgres.translate_sql(
        "UPDATE workers SET balance = balance + ? WHERE name=?"
    ) == "UPDATE workers SET balance = balance + %s WHERE name=%s"


def test_ddl_translation(pkg):
    ddl = pkg.postgres.translate_ddl(
        "CREATE TABLE t (id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "created_at REAL NOT NULL, surreal TEXT)"
    )
    assert "BIGSERIAL PRIMARY KEY" in ddl
    assert "created_at DOUBLE PRECISION NOT NULL" in ddl
    assert "surreal TEXT" in ddl  # word-boundary: REAL inside a name survives


def test_migrations_translate_equally_in_both_packages():
    ref, port = _package("jax"), _package("torch")
    assert port.database.MIGRATIONS == ref.database.MIGRATIONS
    for (version, sql), (_, ref_sql) in zip(port.database.MIGRATIONS,
                                            ref.database.MIGRATIONS):
        out = port.postgres.translate_ddl(sql)
        assert out == ref.postgres.translate_ddl(ref_sql), version
        assert "AUTOINCREMENT" not in out and " REAL" not in out
        assert port.postgres.translate_sql(sql) == \
            ref.postgres.translate_sql(ref_sql)
        assert port.database.split_statements(out) == \
            ref.database.split_statements(out)


def test_url_routing_sqlite(pkg):
    for url in (":memory:", "sqlite://:memory:"):
        db = pkg.database.connect_database(url)
        assert type(db).__name__ == "Database"
        db.close()


def test_url_routing_rejects_unknown_scheme(pkg):
    """A typo'd or unsupported DSN must fail loudly, not become a
    throwaway SQLite file named after the URL."""
    for url in ("mysql://u:p@h/db", "postgre://u:p@h/db"):
        with pytest.raises(ValueError, match="unsupported database scheme"):
            pkg.database.connect_database(url)


@pytest.mark.skipif(_have_driver(), reason="psycopg installed")
def test_vendored_driver_selected_without_psycopg(pkg):
    kind, mod = pkg.postgres._load_driver()
    assert kind == "pgwire" and mod is pkg.pgwire


def test_split_statements_respects_literals(pkg):
    split = pkg.database.split_statements
    assert split("CREATE TABLE a (x INT); CREATE INDEX i ON a(x);") == [
        "CREATE TABLE a (x INT)", "CREATE INDEX i ON a(x)",
    ]
    s = "INSERT INTO t VALUES ('a;b'); SELECT 1"
    assert split(s) == ["INSERT INTO t VALUES ('a;b')", "SELECT 1"]
    s = "INSERT INTO t VALUES ('it''s; fine'); SELECT 2"
    assert split(s) == ["INSERT INTO t VALUES ('it''s; fine')", "SELECT 2"]
    fn = ("CREATE FUNCTION f() RETURNS int AS $body$ BEGIN RETURN 1; END; "
          "$body$ LANGUAGE plpgsql")
    assert split(fn + "; SELECT 3") == [fn, "SELECT 3"]
    assert split("SELECT $$$ ; $$; SELECT 2") == ["SELECT $$$ ; $$", "SELECT 2"]
    s = "CREATE TABLE t (\n  b INTEGER -- miner's atomic units\n); SELECT 4"
    assert split(s) == [
        "CREATE TABLE t (\n  b INTEGER -- miner's atomic units\n)", "SELECT 4",
    ]
    s = "SELECT /* don't; split */ 5; SELECT 6"
    assert split(s) == ["SELECT /* don't; split */ 5", "SELECT 6"]
    s = "CREATE FUNCTION g() AS $v1$ a; b $v1$ LANGUAGE sql; SELECT 7"
    assert split(s) == ["CREATE FUNCTION g() AS $v1$ a; b $v1$ LANGUAGE sql",
                        "SELECT 7"]


def _seeded_values(seed: int) -> list:
    """Literals of every adaptable type: quotes, semicolons, dollar
    signs, backslashes, unicode, bytes, ints past 2^63, floats."""
    rng = np.random.default_rng(seed)
    alphabet = list("ab;'$\\%\" \n-/*é") + ["--", "$$", "''"]
    out: list = [None, True, False, float("nan"), float("inf"), -0.0]
    for _ in range(60):
        n = int(rng.integers(0, 12))
        out.append("".join(rng.choice(alphabet, size=n)))
        out.append(bytes(rng.integers(0, 256, size=n, dtype=np.uint8)))
        out.append(int(rng.integers(-2**62, 2**62)) * int(rng.integers(1, 9)))
        out.append(float(rng.standard_normal()) * 10.0 ** int(rng.integers(-8, 9)))
    return out


def test_split_interpolate_and_escape_agree_on_seeded_values():
    ref, port = _package("jax"), _package("torch")
    values = _seeded_values(20261017)
    for v in values:
        assert port.pgwire.escape_literal(v) == ref.pgwire.escape_literal(v)
    sql = "INSERT INTO t VALUES (" + ", ".join(["%s"] * len(values)) + \
        "); SELECT 100%%; SELECT %s"
    params = tuple(values) + ("x;y",)
    text = port.pgwire.interpolate(sql, params)
    assert text == ref.pgwire.interpolate(sql, params)
    assert port.database.split_statements(text) == \
        ref.database.split_statements(text)
    assert len(port.database.split_statements(text)) == 3


def test_pgwire_interpolation_and_escaping(pkg):
    pgwire = pkg.pgwire
    assert pgwire.interpolate("SELECT %s, %s", (1, "a'b")) == \
        "SELECT 1, 'a''b'"
    assert pgwire.interpolate("SELECT 100%%", ()) == "SELECT 100%"
    assert pgwire.interpolate("%s", (None,)) == "NULL"
    assert pgwire.interpolate("%s", (True,)) == "TRUE"
    assert pgwire.interpolate("%s", (2.5,)) == "2.5"
    assert pgwire.interpolate("%s", (b"\x01\xff",)) == "'\\x01ff'::bytea"
    with pytest.raises(pgwire.ProgrammingError):
        pgwire.interpolate("SELECT %s, %s", (1,))
    with pytest.raises(pgwire.ProgrammingError):
        pgwire.interpolate("SELECT %s", (1, 2))
    with pytest.raises(pgwire.ProgrammingError):
        pgwire.interpolate("%s", ("bad\x00nul",))


# -- the vendored wire driver against the loopback v3 emulator ----------------

def test_pgwire_against_wire_emulator(pkg):
    """The vendored driver speaks the real v3 protocol: startup with
    cleartext auth, simple queries, typed decoding, error cycle."""
    pgwire = pkg.pgwire
    with PgEmulator() as emu:
        conn = pgwire.connect(emu.dsn)
        try:
            cur = conn.cursor()
            cur.execute("CREATE TABLE t (id INTEGER PRIMARY KEY "
                        "AUTOINCREMENT, name TEXT, score REAL)")
            cur.execute("INSERT INTO t (name, score) VALUES (%s, %s) "
                        "RETURNING id", ("o'hara", 2.5))
            assert cur.fetchone() == {"id": 1}
            cur.execute("SELECT id, name, score FROM t")
            rows = cur.fetchall()
            assert rows == [{"id": 1, "name": "o'hara", "score": 2.5}]
            assert isinstance(rows[0]["id"], int)
            assert isinstance(rows[0]["score"], float)
            # error cycle: the connection survives a bad statement
            with pytest.raises(pgwire.DatabaseError, match="no such"):
                cur.execute("SELECT * FROM missing_table")
            cur.execute("SELECT COUNT(*) AS c FROM t")
            assert cur.fetchone()["c"] == 1
            with pytest.raises((pgwire.DatabaseError,
                                pgwire.OperationalError)):
                pgwire.connect(emu.dsn.replace(":soak@", ":wrong@"))
        finally:
            conn.close()
        assert emu.queries >= 5  # the wire really carried the SQL


def test_pgwire_parses_parameter_status_and_refuses_scs_off(pkg):
    """Literal escaping is complete only under
    standard_conforming_strings=on: the startup parses ParameterStatus
    and refuses a server that reports it off, and a mid-session flip
    stops the next query before it is sent."""
    pgwire = pkg.pgwire
    with PgEmulator(parameters={
            "standard_conforming_strings": "on", "TimeZone": "UTC"}) as emu:
        conn = pgwire.connect(emu.dsn)
        try:
            assert conn.parameters["standard_conforming_strings"] == "on"
            assert conn.parameters["TimeZone"] == "UTC"
            assert "server_version" in conn.parameters
        finally:
            conn.close()
    with PgEmulator(parameters={
            "standard_conforming_strings": "off"}) as emu:
        with pytest.raises(pgwire.OperationalError,
                           match="standard_conforming_strings"):
            pgwire.connect(emu.dsn)
    with PgEmulator() as emu:
        conn = pgwire.connect(emu.dsn)
        try:
            conn.parameters["standard_conforming_strings"] = "off"
            with pytest.raises(pgwire.OperationalError,
                               match="standard_conforming_strings"):
                conn.cursor().execute("SELECT 1")
            assert emu.queries == 0, "refused query still hit the wire"
        finally:
            conn.close()


def _repositories_round_trip(pkg, db) -> None:
    """``tests/test_pool.py``'s repository walk, over PostgreSQL."""
    assert type(db).__name__ == "PostgresDatabase"
    assert db.schema_version() >= 2
    workers = pkg.db.WorkerRepository(db)
    shares = pkg.db.ShareRepository(db)
    blocks = pkg.db.BlockRepository(db)
    payouts = pkg.db.PayoutRepository(db)

    workers.upsert("alice", wallet="addr1")
    workers.upsert("alice")  # conflict path keeps the wallet
    workers.record_share("alice", True)
    workers.credit("alice", 5000)
    w = workers.get("alice")
    assert w["wallet"] == "addr1" and w["balance"] == 5000
    assert w["shares_valid"] == 1

    sid = shares.create("alice", "job1", 16.0, actual_difficulty=18.5)
    assert isinstance(sid, int) and sid > 0
    assert shares.count() == 1
    assert shares.last_n(10)[0]["worker"] == "alice"
    assert shares.prune_before(time.time() + 1) == 1

    assert blocks.create("beef" * 16, "alice", height=7, reward=50) > 0
    blocks.set_status("beef" * 16, "confirmed", confirmations=3)
    assert blocks.list()[0]["status"] == "confirmed"
    assert blocks.pending() == []

    pid = payouts.create("alice", "addr1", 2500)
    payouts.mark_sent(pid, "tx99")
    assert payouts.for_worker("alice")[0]["tx_id"] == "tx99"
    assert payouts.pending() == []

    with db.transaction():
        workers.credit("alice", 1)
    assert workers.get("alice")["balance"] == 5001

    db.audit("admin", "switch", "x11")
    rows = db.query_audit(actor="admin")
    assert rows and rows[0]["action"] == "switch"


def test_postgres_migrations_and_repos(pkg, monkeypatch):
    """The live tier: a real server when ``OTEDAMA_TEST_PG_DSN`` is set
    (through whichever driver the package selects), else the emulator
    stands in for it, reached by a ``postgresql://`` DSN."""
    if PG_DSN:
        db = pkg.database.connect_database(PG_DSN)
        try:
            for t in ("shares", "blocks", "payouts", "workers", "audit_log"):
                db.execute(f"DELETE FROM {t}")
            _repositories_round_trip(pkg, db)
        finally:
            db.close()
        return
    monkeypatch.setattr(pkg.postgres, "_load_driver",
                        lambda: ("pgwire", pkg.pgwire))
    with PgEmulator() as emu:
        db = pkg.database.connect_database(
            emu.dsn.replace("postgres://", "postgresql://"))
        try:
            _repositories_round_trip(pkg, db)
        finally:
            db.close()


def test_postgres_tier_live_on_emulator(pgwire_only):
    """The whole PostgreSQL tier over the v3 wire protocol: migrations
    under the advisory lock, RETURNING-id plumbing, paramstyle
    interpolation, repositories, transactions, audit."""
    pkg = pgwire_only
    with PgEmulator() as emu:
        db = pkg.database.connect_database(emu.dsn)
        try:
            _repositories_round_trip(pkg, db)
        finally:
            db.close()
        assert emu.queries > 30  # migrations + repos all rode the wire


def _ledger_batch(pkg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        diff = float(rng.uniform(0.5, 64.0))
        header = rng.integers(0, 256, size=80, dtype=np.uint8).tobytes()
        out.append(pkg.server.AcceptedShare(
            session_id=i, worker_user=f"w.{int(rng.integers(0, 5))}",
            job_id=f"j{i % 3}", difficulty=diff,
            actual_difficulty=diff * float(rng.uniform(1.0, 3.0)),
            digest=bytes(32), header=header,
            extranonce2=struct.pack(">I", i), ntime=1_700_000_000,
            nonce_word=i, is_block=False, submitted_at=1_700_000_000.0 + i,
        ))
    return out


def test_ledger_batch_books_equal_rows_through_both_packages(monkeypatch):
    results = []
    for name in sorted(PACKAGES):
        pkg = _package(name)
        monkeypatch.setattr(pkg.postgres, "_load_driver",
                            lambda pkg=pkg: ("pgwire", pkg.pgwire))
        with PgEmulator() as emu:
            db = pkg.database.connect_database(emu.dsn)
            try:
                pm = pkg.manager.PoolManager(
                    db, pkg.chain.MockChainClient(),
                    config=pkg.manager.PoolConfig(payout=pkg.payouts.PayoutConfig(
                        scheme=pkg.payouts.PayoutScheme.PPS,
                        pps_rate_per_diff1=1e12)))
                outcomes = asyncio.run(pm.on_share_batch(_ledger_batch(pkg, 9)))
                shares = db.query(
                    "SELECT id, worker, job_id, difficulty, actual_difficulty, "
                    "is_block FROM shares ORDER BY id")
                workers = db.query(
                    "SELECT name, shares_valid, shares_invalid, balance "
                    "FROM workers ORDER BY name")
            finally:
                db.close()
        results.append((outcomes, shares, workers))
    assert results[0] == results[1]
    outcomes, shares, workers = results[1]
    assert outcomes == [("ok", "")] * 24 and len(shares) == 24
    assert sum(w["shares_valid"] for w in workers) == 24
    assert all(w["balance"] > 0 for w in workers)
