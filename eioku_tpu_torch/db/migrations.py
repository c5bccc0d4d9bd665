"""Versioned migration runner (first-party mini-alembic).

Copy of eioku_tpu/db/migrations.py for the PyTorch port.

Capability parity: the reference runs `alembic upgrade head` at every process start
(backend/src/database/migrations.py:10-45) over 23 migration files.
Here migrations are ordered modules in eioku_tpu/db/migrations_defs.py; applied
versions are tracked in `schema_migrations` and application is idempotent.
"""
from __future__ import annotations

import logging
import sqlite3

from eioku_tpu_torch.db.connection import Database, execute_script  # noqa: F401  (re-export)
from eioku_tpu_torch.db.migrations_defs import MIGRATIONS

log = logging.getLogger(__name__)


def run_migrations(db: Database) -> int:
    """Apply all unapplied migrations in order. Returns number applied."""
    from datetime import datetime, timezone

    with db.transaction() as conn:
        conn.execute(
            "CREATE TABLE IF NOT EXISTS schema_migrations ("
            " version INTEGER PRIMARY KEY,"
            " name TEXT NOT NULL,"
            " applied_at TEXT NOT NULL)"
        )
    applied = {r[0] for r in db.query("SELECT version FROM schema_migrations")}
    count = 0
    for version, name, up in MIGRATIONS:
        if version in applied:
            continue
        with db.transaction() as conn:
            up(conn, db.dialect)
            conn.execute(
                "INSERT INTO schema_migrations (version, name, applied_at)"
                " VALUES (?, ?, ?)",
                (version, name,
                 datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")),
            )
        log.info("applied migration", extra={"version": version, "migration": name})
        count += 1
    return count


def current_version(db: Database) -> int:
    try:
        v = db.scalar("SELECT MAX(version) FROM schema_migrations")
        return v or 0
    except sqlite3.OperationalError:
        return 0
