"""Video repository.

Copy of eioku_tpu/repositories/video_repository.py for the PyTorch port.

Capability parity: backend/src/repositories/video_repository.py:1-160
(CRUD + projection-backed location read).
"""
from __future__ import annotations

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.models import Video, VideoStatus
from eioku_tpu_torch.repositories._util import dt_to_str, str_to_dt


def _row_to_video(r) -> Video:
    return Video(
        id=r["id"],
        path=r["path"],
        file_hash=r["file_hash"],
        size_bytes=r["size_bytes"],
        duration_ms=r["duration_ms"],
        status=VideoStatus(r["status"]),
        created_at=str_to_dt(r["created_at"]),
        file_created_at=str_to_dt(r["file_created_at"]),
        processed_at=str_to_dt(r["processed_at"]),
    )


class VideoRepository:
    def __init__(self, db: Database):
        self.db = db

    def save(self, v: Video) -> Video:
        self.db.execute(
            "INSERT INTO videos (id, path, file_hash, size_bytes, duration_ms, status,"
            " created_at, file_created_at, processed_at)"
            " VALUES (?,?,?,?,?,?,?,?,?)"
            " ON CONFLICT(id) DO UPDATE SET path=excluded.path, file_hash=excluded.file_hash,"
            " size_bytes=excluded.size_bytes, duration_ms=excluded.duration_ms,"
            " status=excluded.status, file_created_at=excluded.file_created_at,"
            " processed_at=excluded.processed_at",
            (v.id, v.path, v.file_hash, v.size_bytes, v.duration_ms, v.status.value,
             dt_to_str(v.created_at), dt_to_str(v.file_created_at), dt_to_str(v.processed_at)),
        )
        return v

    def get(self, video_id: str) -> Video | None:
        r = self.db.query_one("SELECT * FROM videos WHERE id=?", (video_id,))
        return _row_to_video(r) if r else None

    def get_by_path(self, path: str) -> Video | None:
        r = self.db.query_one("SELECT * FROM videos WHERE path=?", (path,))
        return _row_to_video(r) if r else None

    def list(self, status: VideoStatus | None = None,
             sort_by: str = "created_at", descending: bool = True,
             name_filter: str | None = None,
             limit: int = 1000, offset: int = 0) -> list[Video]:
        """Library listing with sort + name filter (spec req 8.4: sorting and
        filtering by date, filename, or duration)."""
        order_col = {"created_at": "created_at", "path": "path",
                     "duration_ms": "duration_ms", "size_bytes": "size_bytes",
                     "file_created_at": "file_created_at"}.get(
                         sort_by, "created_at")
        clauses, params = [], []
        if status is not None:
            clauses.append("status=?"); params.append(status.value)
        if name_filter:
            clauses.append(f"path {self.db.dialect.ilike()} ?")
            params.append(f"%{name_filter}%")
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        direction = "DESC" if descending else "ASC"
        rows = self.db.query(
            f"SELECT * FROM videos {where}"
            f" ORDER BY {order_col} {direction} LIMIT ? OFFSET ?",
            (*params, limit, offset))
        return [_row_to_video(r) for r in rows]

    def delete(self, video_id: str) -> bool:
        cur = self.db.execute("DELETE FROM videos WHERE id=?", (video_id,))
        return cur.rowcount > 0

    def count(self, status: VideoStatus | None = None,
              name_filter: str | None = None) -> int:
        clauses, params = [], []
        if status is not None:
            clauses.append("status=?"); params.append(status.value)
        if name_filter:
            clauses.append(f"path {self.db.dialect.ilike()} ?")
            params.append(f"%{name_filter}%")
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        return self.db.scalar(f"SELECT COUNT(*) FROM videos {where}",
                              tuple(params))

    def get_location(self, video_id: str) -> dict | None:
        """Read the video_locations projection (reference: video_repository.py:103-128)."""
        r = self.db.query_one("SELECT * FROM video_locations WHERE asset_id=?", (video_id,))
        if r is None:
            return None
        return {
            "latitude": r["latitude"],
            "longitude": r["longitude"],
            "country": r["country"],
            "state": r["state"],
            "city": r["city"],
        }
