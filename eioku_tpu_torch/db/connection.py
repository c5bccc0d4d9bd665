"""First-party sqlite3 engine.

Copy of eioku_tpu/db/connection.py for the PyTorch port.

Replaces the reference's SQLAlchemy engine + scoped sessions
(backend/src/database/connection.py:6-62). Design choices:
  - One connection per Database instance with an RLock serializing transactions.
    SQLite serializes writers anyway; WAL mode lets concurrent *processes*
    (API service + workers) share the same file, which is how the reference's
    PG pool is used in practice.
  - URL forms: "sqlite:///relative/path.db", "sqlite:////abs/path.db",
    "sqlite:///:memory:", or a bare filesystem path.
  - PostgreSQL (the reference's deploy dialect, dev/docker-compose.yml:68) is
    served by PostgresDatabase below via the connect() factory: same
    interface, qmark SQL translated to %s at execute time, dialect-divergent
    SQL built by db.dialect (eioku_tpu/db/dialect.py). The driver is
    psycopg2 or pg8000 when importable, else the first-party wire-protocol
    client (db/pgwire.py) — so postgresql:// URLs execute even in this
    driverless image. The PG SQL surface is unit-tested driver-free
    (tests/test_pg_dialect.py); the wire client against a scripted protocol
    server (tests/test_pgwire.py).
"""
from __future__ import annotations

import os
import sqlite3
import threading
from contextlib import contextmanager
from typing import Any, Iterator

from eioku_tpu_torch.db.dialect import POSTGRES, SQLITE, translate_qmark

DEFAULT_DATABASE_URL = "sqlite:///./data/eioku.db"


def _parse_sqlite_url(url: str) -> str:
    if url.startswith("sqlite:///"):
        return url[len("sqlite:///"):]
    if url.startswith("sqlite://"):
        return url[len("sqlite://"):] or ":memory:"
    return url


class Database:
    dialect = SQLITE

    def __init__(self, url: str | None = None):
        url = url or os.environ.get("EIOKU_DATABASE_URL") or os.environ.get(
            "DATABASE_URL") or DEFAULT_DATABASE_URL
        if url.startswith(("postgresql://", "postgres://")):
            raise RuntimeError(
                "Database is the sqlite engine; use connect(url) to open "
                "PostgreSQL URLs (psycopg2/pg8000 when importable, else the "
                "first-party db/pgwire.py client)"
            )
        self.url = url
        self.path = _parse_sqlite_url(url)
        if self.path not in (":memory:", "") and not self.path.startswith("file:"):
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
        self._lock = threading.RLock()
        self._txn_depth = 0
        # isolation_level=None: full manual transaction control. The module's
        # legacy auto-BEGIN starts DEFERRED transactions only before DML, so
        # read-check-then-write sequences would not be atomic across
        # processes; transaction() below issues BEGIN IMMEDIATE instead.
        self._conn = sqlite3.connect(
            self.path, check_same_thread=False, timeout=30.0,
            isolation_level=None, uri=self.path.startswith("file:"),
        )
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._conn.execute("PRAGMA busy_timeout=10000")
        if self.path != ":memory:":
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")

    @contextmanager
    def transaction(self) -> Iterator[sqlite3.Connection]:
        """Serialized transaction scope; commits on success, rolls back on
        error. BEGIN IMMEDIATE takes the write lock up front so
        read-check-then-write sequences (job dedup, claim-once) are atomic
        against other processes. Re-entrant: nested scopes (and execute()
        calls inside a scope) join the outer transaction instead of
        committing it mid-flight."""
        with self._lock:
            outermost = self._txn_depth == 0
            if outermost:
                self._conn.execute("BEGIN IMMEDIATE")
            self._txn_depth += 1
            try:
                yield self._conn
            except BaseException:
                self._txn_depth -= 1
                if outermost:
                    self._conn.rollback()
                raise
            self._txn_depth -= 1
            if outermost:
                self._conn.commit()

    def execute(self, sql: str, params: tuple | dict = ()) -> sqlite3.Cursor:
        with self._lock:
            return self._conn.execute(sql, params)

    def executemany(self, sql: str, seq: list[tuple]) -> None:
        with self._lock:
            self._conn.executemany(sql, seq)

    def query(self, sql: str, params: tuple | dict = ()) -> list[sqlite3.Row]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def query_one(self, sql: str, params: tuple | dict = ()) -> sqlite3.Row | None:
        with self._lock:
            return self._conn.execute(sql, params).fetchone()

    def scalar(self, sql: str, params: tuple | dict = ()) -> Any:
        row = self.query_one(sql, params)
        return None if row is None else row[0]

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def execute_script(conn: sqlite3.Connection, script: str) -> None:
    """Run a multi-statement SQL script INSIDE the current transaction.

    sqlite3's executescript() implicitly COMMITs any pending transaction
    (even with isolation_level=None), which would break the per-migration
    atomicity: a failure mid-script would leave partial schema with no
    version row, wedging every subsequent startup on 'table already
    exists'. Statements are split with sqlite3.complete_statement so
    semicolons inside trigger bodies (FTS sync triggers) survive.
    """
    buf = ""
    for line in script.splitlines(keepends=True):
        buf += line
        if sqlite3.complete_statement(buf):
            stmt = buf.strip()
            if stmt:
                conn.execute(stmt)
            buf = ""
    if buf.strip():
        conn.execute(buf)



class _PgRow:
    """Row supporting r["col"], r[0], iteration, and dict(r) — the sqlite3.Row
    surface the repositories rely on."""

    __slots__ = ("_cols", "_vals")

    def __init__(self, cols: tuple[str, ...], vals: tuple):
        self._cols, self._vals = cols, vals

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._vals[self._cols.index(key)]
        return self._vals[key]

    def __iter__(self):
        return iter(self._vals)

    def __len__(self):
        return len(self._vals)

    def keys(self):
        return list(self._cols)


class _PgCursor:
    def __init__(self, cur):
        self._cur = cur

    @property
    def rowcount(self) -> int:
        return self._cur.rowcount

    @property
    def lastrowid(self):  # parity attr; PG callers use INSERT ... RETURNING
        return None

    def _cols(self) -> tuple[str, ...]:
        return tuple(d[0] for d in (self._cur.description or ()))

    def fetchone(self):
        row = self._cur.fetchone()
        return None if row is None else _PgRow(self._cols(), tuple(row))

    def fetchall(self):
        cols = None
        out = []
        for row in self._cur.fetchall():
            cols = cols or self._cols()
            out.append(_PgRow(cols, tuple(row)))
        return out


class _PgConn:
    """Connection adapter yielded by PostgresDatabase.transaction(): matches
    the sqlite3.Connection execute surface and translates qmark placeholders."""

    def __init__(self, raw):
        self._raw = raw

    def execute(self, sql: str, params: tuple | dict = ()) -> _PgCursor:
        cur = self._raw.cursor()
        cur.execute(translate_qmark(sql), tuple(params))
        return _PgCursor(cur)

    def executemany(self, sql: str, seq: list[tuple]) -> None:
        cur = self._raw.cursor()
        cur.executemany(translate_qmark(sql), [tuple(p) for p in seq])


def _import_pg_driver():
    """psycopg2 preferred (the reference's driver), pg8000 as the pure-Python
    fallback, and the first-party wire-protocol client (db/pgwire.py) when
    neither external driver exists — this image ships none, so pgwire is
    what actually executes PostgreSQL URLs here."""
    try:
        import psycopg2  # type: ignore

        return psycopg2
    except ImportError:
        pass
    try:
        import pg8000.dbapi  # type: ignore

        return pg8000.dbapi
    except ImportError:
        from eioku_tpu_torch.db import pgwire

        return pgwire


class PostgresDatabase:
    """PostgreSQL engine with the Database interface (same method surface,
    same qmark SQL — translated per-execute) and dialect=POSTGRES so
    dialect-divergent statements are built in PG form.

    Connection resilience: the reference's engine carries
    pool_pre_ping=True + pool_recycle=300 (backend/src/
    database/connection.py:15-18) so a server restart or idle-timeout kill
    is healed transparently. The single-connection equivalent here is
    reconnect-on-failure: an OperationalError/InterfaceError OUTSIDE any
    transaction reconnects once and retries the statement; inside a
    transaction the error propagates (the caller's transaction() context
    rolls back — a retry would silently split atomicity)."""

    dialect = POSTGRES

    def __init__(self, url: str):
        self._driver = _import_pg_driver()
        self.url = url
        # interface parity with Database: consumers branch on path for
        # file-adjacent storage (thumbnails, semantic index); PG has no file,
        # so they take their tempdir/default branches
        self.path = ""
        self._lock = threading.RLock()
        self._txn_depth = 0
        # connection errors the reconnect path may heal (every supported
        # driver exposes both DBAPI names)
        self._retryable = tuple(
            getattr(self._driver, name)
            for name in ("OperationalError", "InterfaceError")
            if hasattr(self._driver, name)) or (OSError,)
        self._raw = self._connect()

    def _connect(self):
        # psycopg2 and the first-party pgwire client take the DSN directly;
        # pg8000.dbapi wants keyword args
        if self._driver.__name__.startswith("psycopg2") \
                or self._driver.__name__.endswith("pgwire"):
            raw = self._driver.connect(self.url)
        else:
            raw = _pg8000_connect(self._driver, self.url)
        raw.autocommit = False
        return raw

    def _reconnect(self):
        try:
            self._raw.close()
        except Exception:
            pass
        self._raw = self._connect()

    def _run(self, op, *, write: bool = False):
        """Run op(conn) under the lock, healing a dead connection outside a
        transaction (pre-ping parity with the reference's pool_pre_ping).

        Reads retry after the failure: re-executing a SELECT is idempotent.
        Writes must execute at most once — a connection can die AFTER the
        server applied the statement but before the client read
        CommandComplete, and a blind retry would silently duplicate the
        INSERT — so writes ping FIRST (SELECT 1) and only a failed ping
        triggers the reconnect; the real statement is never re-executed."""
        with self._lock:
            if write and self._txn_depth == 0:
                try:
                    _PgConn(self._raw).execute("SELECT 1").fetchone()
                except self._retryable:
                    self._reconnect()
                return op(self._raw)
            try:
                return op(self._raw)
            except self._retryable:
                if self._txn_depth != 0 or write:
                    raise  # never split a transaction or re-run a write
                self._reconnect()
                return op(self._raw)

    @contextmanager
    def transaction(self) -> Iterator[_PgConn]:
        with self._lock:
            outermost = self._txn_depth == 0
            self._txn_depth += 1
            try:
                yield _PgConn(self._raw)
            except BaseException:
                self._txn_depth -= 1
                if outermost:
                    try:
                        self._raw.rollback()
                    except self._retryable:
                        # the connection died mid-transaction: the server
                        # aborts the open transaction with the session, so a
                        # fresh connection is the correct rolled-back state
                        self._reconnect()
                raise
            self._txn_depth -= 1
            if outermost:
                self._raw.commit()

    def execute(self, sql: str, params: tuple | dict = ()) -> _PgCursor:
        def op(raw):
            cur = _PgConn(raw).execute(sql, params)
            if self._txn_depth == 0:
                raw.commit()
            return cur

        return self._run(op, write=True)

    def executemany(self, sql: str, seq: list[tuple]) -> None:
        def op(raw):
            _PgConn(raw).executemany(sql, seq)
            if self._txn_depth == 0:
                raw.commit()

        self._run(op, write=True)

    def query(self, sql: str, params: tuple | dict = ()) -> list[_PgRow]:
        def op(raw):
            rows = _PgConn(raw).execute(sql, params).fetchall()
            if self._txn_depth == 0:
                # autocommit is off: without this, a read-mostly process sits
                # "idle in transaction" forever (blocks VACUUM, holds locks)
                raw.commit()
            return rows

        return self._run(op)

    def query_one(self, sql: str, params: tuple | dict = ()) -> _PgRow | None:
        def op(raw):
            row = _PgConn(raw).execute(sql, params).fetchone()
            if self._txn_depth == 0:
                raw.commit()
            return row

        return self._run(op)

    def scalar(self, sql: str, params: tuple | dict = ()) -> Any:
        row = self.query_one(sql, params)
        return None if row is None else row[0]

    def close(self) -> None:
        with self._lock:
            self._raw.close()


def _pg8000_connect(driver, url: str):
    """pg8000.dbapi.connect takes keyword args, not a DSN."""
    from urllib.parse import urlparse

    u = urlparse(url)
    return driver.connect(
        user=u.username or "postgres", password=u.password,
        host=u.hostname or "localhost", port=u.port or 5432,
        database=(u.path or "/").lstrip("/") or "postgres")


def connect(url: str | None = None) -> "Database | PostgresDatabase":
    """Open a database by URL scheme: sqlite:/// (or bare path) -> Database,
    postgresql:// -> PostgresDatabase. The entrypoints' single construction
    point (reference analog: database/connection.py:6-62 engine factory)."""
    url = url or os.environ.get("EIOKU_DATABASE_URL") or os.environ.get(
        "DATABASE_URL") or DEFAULT_DATABASE_URL
    if url.startswith(("postgresql://", "postgres://")):
        return PostgresDatabase(url)
    return Database(url)


_global_db: Database | None = None
_global_lock = threading.Lock()


def get_database() -> Database:
    """Process-wide default database (lazily created from env)."""
    global _global_db
    with _global_lock:
        if _global_db is None:
            _global_db = connect()
        return _global_db


def set_database(db: Database | None) -> None:
    global _global_db
    with _global_lock:
        _global_db = db
