"""PathConfig repository.

Copy of eioku_tpu/repositories/path_config_repository.py for the PyTorch port.

Capability parity: backend/src/repositories/path_config_repository.py:1-83.
"""
from __future__ import annotations

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.models import PathConfig
from eioku_tpu_torch.repositories._util import dt_to_str, str_to_dt


def _row(r) -> PathConfig:
    return PathConfig(
        id=r["id"], path=r["path"], recursive=bool(r["recursive"]),
        enabled=bool(r["enabled"]), created_at=str_to_dt(r["created_at"]),
    )


class PathConfigRepository:
    def __init__(self, db: Database):
        self.db = db

    def save(self, pc: PathConfig) -> PathConfig:
        self.db.execute(
            "INSERT INTO path_configs (id, path, recursive, enabled, created_at)"
            " VALUES (?,?,?,?,?) ON CONFLICT(path) DO UPDATE SET"
            " recursive=excluded.recursive, enabled=excluded.enabled",
            (pc.id, pc.path, int(pc.recursive), int(pc.enabled), dt_to_str(pc.created_at)),
        )
        return pc

    def get_by_path(self, path: str) -> PathConfig | None:
        r = self.db.query_one("SELECT * FROM path_configs WHERE path=?", (path,))
        return _row(r) if r else None

    def list(self, enabled_only: bool = False) -> list[PathConfig]:
        sql = "SELECT * FROM path_configs"
        if enabled_only:
            sql += " WHERE enabled=1"
        return [_row(r) for r in self.db.query(sql + " ORDER BY created_at")]

    def delete(self, path: str) -> bool:
        cur = self.db.execute("DELETE FROM path_configs WHERE path=?", (path,))
        return cur.rowcount > 0
