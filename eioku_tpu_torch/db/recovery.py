"""Database corruption detection + salvage recovery (spec req 7.4:

Copy of eioku_tpu/db/recovery.py for the PyTorch port.
"WHEN data corruption is detected, THE System SHALL attempt recovery and
notify the user" — .kiro/specs/semantic-video-search/requirements.md).

Startup runs PRAGMA quick_check on file-backed sqlite databases. On
corruption the recovery path salvages what it can: a fresh database is
migrated to the current schema, every readable row of every ordinary table is
copied (per-row, skipping unreadable pages), the corrupt original is kept
next to the new file as `<name>.corrupt-<ts>`, and FTS projections — whose
shadow tables are the most fragile part of a torn sqlite file — are rebuilt
from the salvaged artifacts table. The outcome is surfaced on /health and in
the JSON log so operators are notified rather than discovering silent data
loss later.
"""
from __future__ import annotations

import logging
import os
import sqlite3
import time
from typing import Any

log = logging.getLogger(__name__)

# report of the most recent check/recovery in this process, shown by /health
LAST_REPORT: dict[str, Any] = {"checked": False}

# source-of-truth tables worth salvaging, in FK-friendly order. Projections
# (FTS pairs, scene_ranges, object_labels, face_clusters, video_locations,
# embedding_chunks) are deliberately NOT copied: the startup path rebuilds
# them all from the salvaged artifacts table (resync_all), so copying them
# here would be double work thrown away. topics has no artifact source, so
# it IS salvaged.
_SALVAGE_TABLES = (
    "schema_migrations", "videos", "path_configs", "tasks", "runs",
    "artifacts", "artifact_selections", "jobs", "topics",
)


def _quick_check(path: str) -> tuple[bool, str]:
    try:
        conn = sqlite3.connect(path, timeout=10.0)
        try:
            rows = conn.execute("PRAGMA quick_check(5)").fetchall()
        finally:
            conn.close()
        detail = "; ".join(str(r[0]) for r in rows)
        return detail == "ok", detail
    except sqlite3.DatabaseError as e:
        return False, f"unreadable: {e}"


def _salvage_rows(src: sqlite3.Connection, dst: sqlite3.Connection,
                  table: str) -> tuple[int, int]:
    """Copy every readable row; returns (copied, lost)."""
    copied = lost = 0
    try:
        cur = src.execute(f"SELECT * FROM {table}")
        cols = [d[0] for d in cur.description]
    except sqlite3.DatabaseError:
        return 0, -1  # whole table unreadable; -1 = unknown loss
    placeholders = ",".join("?" * len(cols))
    sql = (f"INSERT OR IGNORE INTO {table} ({', '.join(cols)})"
           f" VALUES ({placeholders})")
    while True:
        try:
            row = cur.fetchone()
        except sqlite3.DatabaseError:
            lost += 1
            break  # a torn page ends the scan; everything before it is saved
        if row is None:
            break
        try:
            dst.execute(sql, tuple(row))
            copied += 1
        except sqlite3.Error:
            lost += 1
    return copied, lost


def check_and_recover(path: str) -> dict[str, Any]:
    """Quick-check `path`; salvage-rebuild it when corrupt.

    Returns (and stores in LAST_REPORT) a dict: ok, recovered, detail, and
    per-table copied/lost counts when a salvage ran. The corrupt original is
    preserved as `<path>.corrupt-<ts>`.
    """
    global LAST_REPORT
    report: dict[str, Any] = {"checked": True, "ok": True, "recovered": False,
                              "detail": "ok"}
    if not path or path == ":memory:" or not os.path.isfile(path):
        LAST_REPORT = report
        return report
    ok, detail = _quick_check(path)
    if ok:
        LAST_REPORT = report
        return report

    log.error("database corruption detected; attempting salvage recovery",
              extra={"db": path, "detail": detail})
    report.update(ok=False, detail=detail)
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    corrupt_copy = f"{path}.corrupt-{stamp}"
    new_path = f"{path}.recovered-{stamp}"

    try:
        # fresh schema first (migrations create FTS + indexes), then copy
        from eioku_tpu_torch.db.connection import Database
        from eioku_tpu_torch.db.migrations import run_migrations

        new_db = Database(f"sqlite:///{new_path}")
        run_migrations(new_db)
        # the fresh schema_migrations rows STAY: the salvage INSERT OR
        # IGNOREs on version, and if the corrupt file's own migration table
        # is unreadable the fresh rows are what stops run_migrations from
        # re-CREATE-ing every table on the recovered db at next startup
        src = sqlite3.connect(path, timeout=10.0)
        tables: dict[str, dict[str, int]] = {}
        with new_db.transaction() as dst:
            for table in _SALVAGE_TABLES:
                copied, lost_n = _salvage_rows(src, dst, table)
                tables[table] = {"copied": copied, "lost": lost_n}
        src.close()
        new_db.close()
        os.replace(path, corrupt_copy)
        for suffix in ("-wal", "-shm"):
            if os.path.isfile(path + suffix):
                os.replace(path + suffix, corrupt_copy + suffix)
        os.replace(new_path, path)
        report.update(recovered=True, tables=tables,
                      corrupt_backup=corrupt_copy)
        log.error("database salvage complete — verify the row counts; the "
                  "corrupt original is preserved",
                  extra={"db": path, "backup": corrupt_copy,
                         "tables": tables})
    except Exception as e:  # salvage must never brick startup harder
        report.update(recovered=False, detail=f"{detail}; salvage failed: {e}")
        log.exception("database salvage failed", extra={"db": path})
    LAST_REPORT = report
    return report
