"""Task <-> queue reconciliation: the failure-detection/recovery subsystem.

Copy of eioku_tpu/services/reconciler.py for the PyTorch port.

Capability parity: backend/src/workers/reconciler.py:27-401, which
repairs PostgreSQL<->Redis drift. This framework's queue shares the database with
the task table, so whole classes of drift (queue data loss) cannot happen; the
reconciler still covers:
  1. PENDING tasks with no active job -> re-enqueue with refetched video path/config
     (covers lost enqueues, e.g. crash between task insert and enqueue).
  2. RUNNING tasks whose job finished -> sync completed/failed status to the task.
  3. RUNNING tasks with no active job (worker crash, lease expiry) -> reset to
     PENDING and re-enqueue.
  4. Long-running tasks (> alert_after_s) -> structured warning, never auto-kill
     (reference alerts at 3600 s, reconciler.py:286-318).
  5. Expired job leases -> requeue/fail via the queue itself.

The reference duplicated this logic in backend and ml-service with the ml-side
copy re-enqueuing with an empty path/config (a noted defect,
ml-service/src/workers/reconciler.py:139-145); here there is exactly one
implementation that always refetches real task state.
"""
from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from eioku_tpu_torch.domain.artifacts import utcnow
from eioku_tpu_torch.domain.models import TaskStatus
from eioku_tpu_torch.queue.jobs import JobStatus
from eioku_tpu_torch.queue.producer import JobProducer
from eioku_tpu_torch.repositories.task_repository import TaskRepository
from eioku_tpu_torch.repositories.video_repository import VideoRepository

log = logging.getLogger(__name__)

DEFAULT_INTERVAL_S = 300.0
DEFAULT_ALERT_AFTER_S = 3600.0


@dataclass
class ReconcileReport:
    pending_reenqueued: int = 0
    running_reset: int = 0
    statuses_synced: int = 0
    leases_requeued: int = 0
    long_running_alerts: int = 0
    low_disk_alerts: int = 0

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def disk_space_status(path: str = ".", min_free_bytes: int = 2 << 30,
                      min_free_pct: float = 5.0) -> dict:
    """Free-space check for the database/artifact volume (spec req 7.5:
    'provide warnings before running out of disk space'). Low when free
    drops under 2 GB OR 5% of the volume."""
    import shutil

    try:
        usage = shutil.disk_usage(path or ".")
    except OSError:
        return {"checked": False}
    free_pct = 100.0 * usage.free / max(usage.total, 1)
    return {
        "checked": True,
        "free_bytes": usage.free,
        "free_gb": round(usage.free / (1 << 30), 2),
        "free_pct": round(free_pct, 1),
        "low": usage.free < min_free_bytes or free_pct < min_free_pct,
    }


class Reconciler:
    def __init__(self, tasks: TaskRepository, videos: VideoRepository,
                 producer: JobProducer, alert_after_s: float = DEFAULT_ALERT_AFTER_S):
        self.tasks = tasks
        self.videos = videos
        self.producer = producer
        self.alert_after_s = alert_after_s

    def run(self) -> ReconcileReport:
        report = ReconcileReport()
        report.leases_requeued = self.producer.queue.requeue_expired()
        self._sync_pending(report)
        self._sync_running(report)
        self._alert_long_running(report)
        disk = disk_space_status(getattr(self.tasks.db, "path", ".") or ".")
        if disk.get("low"):
            report.low_disk_alerts += 1
            log.warning("storage volume low on space", extra=disk)
        if any(vars(report).values()):
            log.info("reconciliation actions", extra=report.to_dict())
        return report

    def _sync_pending(self, report: ReconcileReport) -> None:
        for task in self.tasks.find(status=TaskStatus.PENDING, limit=10000):
            if self.producer.job_exists(task.id):
                continue
            video = self.videos.get(task.video_id)
            if video is None:
                continue
            if self.producer.enqueue_task(task.id, task.task_type, task.video_id,
                                          video.path, task.config) is not None:
                report.pending_reenqueued += 1

    def _sync_running(self, report: ReconcileReport) -> None:
        for task in self.tasks.find(status=TaskStatus.RUNNING, limit=10000):
            job = self.producer.queue.get(self.producer.job_id_for_task(task.id))
            if job is not None and job.status is JobStatus.COMPLETED:
                self.tasks.update_status(task.id, TaskStatus.COMPLETED)
                report.statuses_synced += 1
            elif job is not None and job.status is JobStatus.FAILED:
                self.tasks.update_status(task.id, TaskStatus.FAILED,
                                         error=job.error or "job failed")
                report.statuses_synced += 1
            elif job is None or job.status is JobStatus.CANCELLED:
                # Worker crashed or job vanished: reset and re-enqueue.
                self.tasks.update_status(task.id, TaskStatus.PENDING)
                video = self.videos.get(task.video_id)
                if video is not None:
                    self.producer.enqueue_task(task.id, task.task_type, task.video_id,
                                               video.path, task.config)
                report.running_reset += 1
            elif job.status is JobStatus.QUEUED:
                # Lease expired and the job was requeued (crashed worker):
                # the task goes back to PENDING until a worker re-claims it
                # (reference: RUNNING w/o job -> reset, reconciler.py:182-284).
                self.tasks.update_status(task.id, TaskStatus.PENDING)
                report.running_reset += 1

    def _alert_long_running(self, report: ReconcileReport) -> None:
        for task in self.tasks.find(status=TaskStatus.RUNNING, limit=10000):
            if task.started_at is None:
                continue
            elapsed = (utcnow() - task.started_at).total_seconds()
            if elapsed > self.alert_after_s:
                report.long_running_alerts += 1
                log.warning("task running too long", extra={
                    "task_id": task.id, "task_type": task.task_type,
                    "elapsed_s": round(elapsed)})


async def periodic_loop(fn, interval_s: float, stop: asyncio.Event,
                        name: str, sleep_first: bool = False) -> None:
    """Shared skeleton for lifespan background loops (reconciliation,
    periodic discovery): run `fn` every interval_s until `stop` is set,
    logging (not propagating) per-iteration failures. Intervals clamp to a
    1 s floor so a bad config value can't busy-loop full library scans."""
    interval_s = max(float(interval_s), 1.0)
    while not stop.is_set():
        if sleep_first:
            try:
                await asyncio.wait_for(stop.wait(), timeout=interval_s)
                return  # stop set during the sleep
            except asyncio.TimeoutError:
                pass
        try:
            out = fn()
            if asyncio.iscoroutine(out):
                await out
        except Exception:
            log.exception("%s failed", name)
        if not sleep_first:
            try:
                await asyncio.wait_for(stop.wait(), timeout=interval_s)
            except asyncio.TimeoutError:
                pass


async def reconciliation_loop(reconciler: Reconciler,
                              interval_s: float = DEFAULT_INTERVAL_S,
                              stop: asyncio.Event | None = None) -> None:
    """Background loop for the API process
    (reference: main_api.py:200-208, every 300 s)."""
    await periodic_loop(reconciler.run, interval_s, stop or asyncio.Event(),
                        "reconciliation")
