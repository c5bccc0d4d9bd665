"""Job model for the first-party durable queue.

Copy of eioku_tpu/queue/jobs.py for the PyTorch port.

The reference used Redis/Valkey + arq as its only inter-process transport
(backend/src/services/job_producer.py:12-135,
config/redis_config.py:14-28). This framework's queue keeps the same *contract* —
named async functions, job-id dedup (enqueue returns None for duplicates),
max_tries, per-job timeout, abort support, cron — but is backed by the metadata
database, which removes the reference's dual-store reconciliation problem: the
queue shares transactions with the task table.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Any

from eioku_tpu_torch.domain.artifacts import utcnow


class JobStatus(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class Job:
    job_id: str
    function: str
    args: list[Any] = field(default_factory=list)
    kwargs: dict[str, Any] = field(default_factory=dict)
    queue: str = "ml_jobs"
    status: JobStatus = JobStatus.QUEUED
    priority: int = 5
    attempts: int = 0
    max_tries: int = 1
    timeout_s: float = 3600.0
    enqueued_at: datetime = field(default_factory=utcnow)
    started_at: datetime | None = None
    finished_at: datetime | None = None
    lease_expires_at: datetime | None = None
    worker_id: str | None = None
    result: Any = None
    error: str | None = None
    abort_requested: bool = False

    def lease(self, worker_id: str) -> None:
        self.status = JobStatus.RUNNING
        self.worker_id = worker_id
        self.attempts += 1
        self.started_at = utcnow()
        self.lease_expires_at = self.started_at + timedelta(seconds=self.timeout_s)

    def to_row(self) -> tuple:
        return (
            self.job_id, self.queue, self.function, json.dumps(self.args),
            json.dumps(self.kwargs), self.status.value, self.priority, self.attempts,
            self.max_tries, self.timeout_s,
            self.enqueued_at.isoformat(),
            self.started_at.isoformat() if self.started_at else None,
            self.finished_at.isoformat() if self.finished_at else None,
            self.lease_expires_at.isoformat() if self.lease_expires_at else None,
            self.worker_id,
            json.dumps(self.result) if self.result is not None else None,
            self.error, int(self.abort_requested),
        )

    @classmethod
    def from_row(cls, r) -> "Job":
        return cls(
            job_id=r["job_id"], queue=r["queue"], function=r["function"],
            args=json.loads(r["args_json"]), kwargs=json.loads(r["kwargs_json"]),
            status=JobStatus(r["status"]), priority=r["priority"], attempts=r["attempts"],
            max_tries=r["max_tries"], timeout_s=r["timeout_s"],
            enqueued_at=datetime.fromisoformat(r["enqueued_at"]),
            started_at=datetime.fromisoformat(r["started_at"]) if r["started_at"] else None,
            finished_at=datetime.fromisoformat(r["finished_at"]) if r["finished_at"] else None,
            lease_expires_at=(datetime.fromisoformat(r["lease_expires_at"])
                              if r["lease_expires_at"] else None),
            worker_id=r["worker_id"],
            result=json.loads(r["result_json"]) if r["result_json"] else None,
            error=r["error"], abort_requested=bool(r["abort_requested"]),
        )
