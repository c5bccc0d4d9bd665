"""Task repository.

Copy of eioku_tpu/repositories/task_repository.py for the PyTorch port.

Capability parity: backend/src/repositories/task_repository.py:12-206,
including the atomic dequeue (the reference used `SELECT FOR UPDATE SKIP LOCKED`;
here the equivalent is a single atomic `UPDATE ... RETURNING` under SQLite's write
lock, giving the same claim-once semantics without row locks).
"""
from __future__ import annotations

import json

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import utcnow
from eioku_tpu_torch.domain.models import Task, TaskStatus
from eioku_tpu_torch.repositories._util import dt_to_str, str_to_dt


def _row_to_task(r) -> Task:
    return Task(
        id=r["id"],
        video_id=r["video_id"],
        task_type=r["task_type"],
        status=TaskStatus(r["status"]),
        priority=r["priority"],
        language=r["language"],
        config=json.loads(r["config_json"]),
        error=r["error"],
        created_at=str_to_dt(r["created_at"]),
        started_at=str_to_dt(r["started_at"]),
        completed_at=str_to_dt(r["completed_at"]),
        attempts=r["attempts"],
        progress=r["progress"],
    )


class TaskRepository:
    def __init__(self, db: Database):
        self.db = db

    def save(self, t: Task) -> Task:
        self.db.execute(
            "INSERT INTO tasks (id, video_id, task_type, status, priority, language,"
            " config_json, error, created_at, started_at, completed_at, attempts,"
            " progress)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"
            " ON CONFLICT(id) DO UPDATE SET status=excluded.status,"
            " priority=excluded.priority, config_json=excluded.config_json,"
            " error=excluded.error, started_at=excluded.started_at,"
            " completed_at=excluded.completed_at, attempts=excluded.attempts,"
            " progress=excluded.progress",
            (t.id, t.video_id, t.task_type, t.status.value, t.priority, t.language,
             json.dumps(t.config), t.error, dt_to_str(t.created_at),
             dt_to_str(t.started_at), dt_to_str(t.completed_at), t.attempts,
             t.progress),
        )
        return t

    def get(self, task_id: str) -> Task | None:
        r = self.db.query_one("SELECT * FROM tasks WHERE id=?", (task_id,))
        return _row_to_task(r) if r else None

    def find(self, video_id: str | None = None, status: TaskStatus | None = None,
             task_type: str | None = None, language: str | None = None,
             sort_by: str = "created_at", descending: bool = True,
             limit: int = 100, offset: int = 0) -> list[Task]:
        clauses, params = [], []
        if video_id is not None:
            clauses.append("video_id=?"); params.append(video_id)
        if status is not None:
            clauses.append("status=?"); params.append(status.value)
        if task_type is not None:
            clauses.append("task_type=?"); params.append(task_type)
        if language is not None:
            clauses.append("language=?"); params.append(language)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        order_col = {
            "created_at": "created_at",
            "started_at": "started_at",
            "completed_at": "completed_at",
            "priority": "priority",
            "running_time": self.db.dialect.running_seconds_expr(),
        }.get(sort_by, "created_at")
        direction = "DESC" if descending else "ASC"
        rows = self.db.query(
            f"SELECT * FROM tasks {where} ORDER BY {order_col} {direction} LIMIT ? OFFSET ?",
            (*params, limit, offset),
        )
        return [_row_to_task(r) for r in rows]

    def count(self, status: TaskStatus | None = None) -> int:
        if status is not None:
            return self.db.scalar("SELECT COUNT(*) FROM tasks WHERE status=?", (status.value,))
        return self.db.scalar("SELECT COUNT(*) FROM tasks")

    def exists(self, video_id: str, task_type: str, language: str | None) -> bool:
        return bool(self.db.scalar(
            "SELECT 1 FROM tasks WHERE video_id=? AND task_type=?"
            " AND COALESCE(language,'')=? LIMIT 1",
            (video_id, task_type, language or ""),
        ))

    def update_status(self, task_id: str, status: TaskStatus,
                      error: str | None = None) -> Task | None:
        """Load-transition-save with domain transition validation."""
        t = self.get(task_id)
        if t is None:
            return None
        t.transition(status)
        if error is not None:
            t.error = error
        return self.save(t)

    def set_progress(self, task_id: str, frac: float) -> None:
        """Cheap mid-run progress write; only touches RUNNING rows so a
        late-arriving report can never repaint a terminal task."""
        self.db.execute(
            "UPDATE tasks SET progress=? WHERE id=? AND status='running'",
            (min(max(float(frac), 0.0), 1.0), task_id))

    def atomic_claim_pending(self, worker_id: str,
                             task_type: str | None = None) -> Task | None:
        """Atomically claim the highest-priority pending task (claim-once semantics).

        Reference analog: task_repository.py:180-206 (FOR UPDATE SKIP LOCKED).
        """
        now = dt_to_str(utcnow())
        type_clause = "AND task_type=?" if task_type else ""
        params = [now] + ([task_type] if task_type else [])
        with self.db.transaction() as conn:
            row = conn.execute(
                f"""UPDATE tasks SET status='running', started_at=?, attempts=attempts+1,
                        progress=0.0
                    WHERE id = (SELECT id FROM tasks WHERE status='pending' {type_clause}
                                ORDER BY priority ASC, created_at ASC LIMIT 1)
                    RETURNING *""",
                params,
            ).fetchone()
        return _row_to_task(row) if row else None

    def delete_for_video(self, video_id: str) -> int:
        cur = self.db.execute("DELETE FROM tasks WHERE video_id=?", (video_id,))
        return cur.rowcount
