"""Queue backends: durable sqlite-backed and in-memory.

Copy of eioku_tpu/queue/queue.py for the PyTorch port.

Semantics (matching the reference's arq usage):
  - enqueue with an explicit job_id deduplicates: a second enqueue while the job
    is queued/running returns None (reference: job_producer.py:99-117).
  - claim is atomic claim-once (UPDATE ... RETURNING under SQLite's write lock).
  - running jobs hold a lease (timeout_s); expired leases (worker crash or
    hang) are requeued while attempts <= max_tries — a crash does not consume
    an execution try, mirroring the reference reconciler's reset-and-re-enqueue
    of RUNNING tasks whose job vanished (reconciler.py:182-284) while staying
    bounded — then failed. Execution failures retry strictly under max_tries.
  - abort: cooperative; workers poll abort_requested (arq allow_abort_jobs).
"""
from __future__ import annotations

import threading
from datetime import datetime, timedelta

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import utcnow
from eioku_tpu_torch.queue.jobs import Job, JobStatus

_COLUMNS = ("job_id, queue, function, args_json, kwargs_json, status, priority,"
            " attempts, max_tries, timeout_s, enqueued_at, started_at, finished_at,"
            " lease_expires_at, worker_id, result_json, error, abort_requested")


class SqliteJobQueue:
    """Durable queue over the jobs table; safe for multi-process use via WAL."""

    def __init__(self, db: Database):
        self.db = db

    # -- producer side ---------------------------------------------------------

    def enqueue(self, job: Job) -> Job | None:
        with self.db.transaction() as conn:
            existing = conn.execute(
                "SELECT status FROM jobs WHERE job_id=?", (job.job_id,)).fetchone()
            if existing is not None:
                if existing["status"] in (JobStatus.QUEUED.value, JobStatus.RUNNING.value):
                    return None  # dedup, arq-compatible behavior
                conn.execute("DELETE FROM jobs WHERE job_id=?", (job.job_id,))
            conn.execute(
                f"INSERT INTO jobs ({_COLUMNS}) VALUES"
                " (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)", job.to_row())
        return job

    def get(self, job_id: str) -> Job | None:
        r = self.db.query_one("SELECT * FROM jobs WHERE job_id=?", (job_id,))
        return Job.from_row(r) if r else None

    def exists_active(self, job_id: str) -> bool:
        return bool(self.db.scalar(
            "SELECT 1 FROM jobs WHERE job_id=? AND status IN ('queued','running')",
            (job_id,)))

    def request_abort(self, job_id: str) -> bool:
        with self.db.transaction() as conn:
            cur = conn.execute(
                "UPDATE jobs SET abort_requested=1 WHERE job_id=?"
                " AND status IN ('queued','running')", (job_id,))
            if cur.rowcount == 0:
                return False
            # queued jobs can be cancelled immediately
            conn.execute(
                "UPDATE jobs SET status='cancelled', finished_at=? WHERE job_id=?"
                " AND status='queued'", (utcnow().isoformat(), job_id))
        return True

    # -- worker side -------------------------------------------------------------

    def claim(self, worker_id: str, queue: str = "ml_jobs") -> Job | None:
        now = utcnow()
        with self.db.transaction() as conn:
            row = conn.execute(
                """UPDATE jobs SET status='running', worker_id=?, attempts=attempts+1,
                       started_at=?
                   WHERE job_id = (SELECT job_id FROM jobs
                                   WHERE queue=? AND status='queued'
                                   ORDER BY priority ASC, enqueued_at ASC LIMIT 1)
                   RETURNING *""",
                (worker_id, now.isoformat(), queue),
            ).fetchone()
            if row is None:
                return None
            # Lease computed in Python so lease_expires_at uses the exact same
            # ISO format as requeue_expired's comparison value.
            lease = (now + timedelta(seconds=row["timeout_s"])).isoformat()
            conn.execute("UPDATE jobs SET lease_expires_at=? WHERE job_id=?",
                         (lease, row["job_id"]))
        job = Job.from_row(row)
        job.lease_expires_at = datetime.fromisoformat(lease)
        return job

    def complete(self, job_id: str, result=None) -> None:
        import json
        self.db.execute(
            "UPDATE jobs SET status='completed', finished_at=?, result_json=?"
            " WHERE job_id=?",
            (utcnow().isoformat(), json.dumps(result) if result is not None else None,
             job_id))

    def fail(self, job_id: str, error: str) -> JobStatus:
        """Fail or requeue depending on attempts vs max_tries. Returns final status."""
        with self.db.transaction() as conn:
            row = conn.execute(
                "SELECT attempts, max_tries FROM jobs WHERE job_id=?", (job_id,)).fetchone()
            if row is None:
                return JobStatus.FAILED
            if row["attempts"] < row["max_tries"]:
                conn.execute(
                    "UPDATE jobs SET status='queued', worker_id=NULL,"
                    " lease_expires_at=NULL, error=? WHERE job_id=?", (error, job_id))
                return JobStatus.QUEUED
            conn.execute(
                "UPDATE jobs SET status='failed', finished_at=?, error=? WHERE job_id=?",
                (utcnow().isoformat(), error, job_id))
            return JobStatus.FAILED

    def cancel(self, job_id: str) -> None:
        self.db.execute(
            "UPDATE jobs SET status='cancelled', finished_at=? WHERE job_id=?",
            (utcnow().isoformat(), job_id))

    def is_abort_requested(self, job_id: str) -> bool:
        return bool(self.db.scalar(
            "SELECT abort_requested FROM jobs WHERE job_id=?", (job_id,)))

    # -- maintenance ---------------------------------------------------------------

    def requeue_expired(self) -> int:
        """Requeue (or fail) running jobs whose lease expired — crash recovery.
        Replaces the reference's RUNNING-without-Redis-job reconciliation
        (backend/src/workers/reconciler.py:182-284)."""
        now = utcnow().isoformat()
        with self.db.transaction() as conn:
            requeued = conn.execute(
                "UPDATE jobs SET status='queued', worker_id=NULL, lease_expires_at=NULL"
                " WHERE status='running' AND lease_expires_at < ? AND attempts <= max_tries",
                (now,)).rowcount
            conn.execute(
                "UPDATE jobs SET status='failed', finished_at=?, error='lease expired'"
                " WHERE status='running' AND lease_expires_at < ?", (now, now))
        return requeued

    def counts(self, queue: str = "ml_jobs") -> dict[str, int]:
        rows = self.db.query(
            "SELECT status, COUNT(*) AS n FROM jobs WHERE queue=? GROUP BY status", (queue,))
        return {r["status"]: r["n"] for r in rows}

    def list_jobs(self, queue: str | None = None, status: JobStatus | None = None,
                  limit: int = 100) -> list[Job]:
        clauses, params = [], []
        if queue:
            clauses.append("queue=?"); params.append(queue)
        if status:
            clauses.append("status=?"); params.append(status.value)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        rows = self.db.query(
            f"SELECT * FROM jobs {where} ORDER BY enqueued_at DESC LIMIT ?",
            (*params, limit))
        return [Job.from_row(r) for r in rows]


class MemoryJobQueue:
    """In-memory queue with identical semantics, for tests and embedded use."""

    def __init__(self):
        self._jobs: dict[str, Job] = {}
        self._lock = threading.RLock()

    def enqueue(self, job: Job) -> Job | None:
        with self._lock:
            existing = self._jobs.get(job.job_id)
            if existing is not None and existing.status in (JobStatus.QUEUED, JobStatus.RUNNING):
                return None
            self._jobs[job.job_id] = job
            return job

    def get(self, job_id: str) -> Job | None:
        return self._jobs.get(job_id)

    def exists_active(self, job_id: str) -> bool:
        j = self._jobs.get(job_id)
        return j is not None and j.status in (JobStatus.QUEUED, JobStatus.RUNNING)

    def request_abort(self, job_id: str) -> bool:
        with self._lock:
            j = self._jobs.get(job_id)
            if j is None or j.status not in (JobStatus.QUEUED, JobStatus.RUNNING):
                return False
            j.abort_requested = True
            if j.status is JobStatus.QUEUED:
                j.status = JobStatus.CANCELLED
                j.finished_at = utcnow()
            return True

    def claim(self, worker_id: str, queue: str = "ml_jobs") -> Job | None:
        with self._lock:
            candidates = [j for j in self._jobs.values()
                          if j.queue == queue and j.status is JobStatus.QUEUED]
            if not candidates:
                return None
            job = min(candidates, key=lambda j: (j.priority, j.enqueued_at))
            job.lease(worker_id)
            return job

    def complete(self, job_id: str, result=None) -> None:
        with self._lock:
            j = self._jobs[job_id]
            j.status = JobStatus.COMPLETED
            j.result = result
            j.finished_at = utcnow()

    def fail(self, job_id: str, error: str) -> JobStatus:
        with self._lock:
            j = self._jobs[job_id]
            j.error = error
            if j.attempts < j.max_tries:
                j.status = JobStatus.QUEUED
                j.worker_id = None
                j.lease_expires_at = None
                return JobStatus.QUEUED
            j.status = JobStatus.FAILED
            j.finished_at = utcnow()
            return JobStatus.FAILED

    def cancel(self, job_id: str) -> None:
        with self._lock:
            j = self._jobs[job_id]
            j.status = JobStatus.CANCELLED
            j.finished_at = utcnow()

    def is_abort_requested(self, job_id: str) -> bool:
        j = self._jobs.get(job_id)
        return bool(j and j.abort_requested)

    def requeue_expired(self) -> int:
        now: datetime = utcnow()
        n = 0
        with self._lock:
            for j in self._jobs.values():
                if j.status is JobStatus.RUNNING and j.lease_expires_at and \
                        j.lease_expires_at < now:
                    if j.attempts <= j.max_tries:
                        j.status = JobStatus.QUEUED
                        j.worker_id = None
                        j.lease_expires_at = None
                        n += 1
                    else:
                        j.status = JobStatus.FAILED
                        j.error = "lease expired"
                        j.finished_at = now
        return n

    def counts(self, queue: str = "ml_jobs") -> dict[str, int]:
        out: dict[str, int] = {}
        for j in self._jobs.values():
            if j.queue == queue:
                out[j.status.value] = out.get(j.status.value, 0) + 1
        return out

    def list_jobs(self, queue: str | None = None, status: JobStatus | None = None,
                  limit: int = 100) -> list[Job]:
        jobs = [j for j in self._jobs.values()
                if (queue is None or j.queue == queue)
                and (status is None or j.status is status)]
        jobs.sort(key=lambda j: j.enqueued_at, reverse=True)
        return jobs[:limit]
