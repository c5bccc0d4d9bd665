"""Job producer: enqueues ML tasks with deterministic job ids for dedup.

Copy of eioku_tpu/queue/producer.py for the PyTorch port.

Capability parity: backend/src/services/job_producer.py:12-135
(enqueue `process_ml_task` on queue `ml_jobs` with `_job_id=f"ml_{task_id}"`;
duplicate enqueues return None; post-enqueue verification).
"""
from __future__ import annotations

import logging
from typing import Any

from eioku_tpu_torch.domain.task_registry import SUPPORTED_TASK_TYPES
from eioku_tpu_torch.queue.jobs import Job

log = logging.getLogger(__name__)

ML_QUEUE = "ml_jobs"
PROCESS_FUNCTION = "process_ml_task"


class JobProducer:
    def __init__(self, queue, default_timeout_s: float | None = None,
                 max_tries: int | None = None):
        import os
        self.queue = queue
        # env defaults mirror the reference's worker knobs
        # (ml-service/src/main_worker.py:124-126) so WORKER_JOB_TIMEOUT /
        # WORKER_MAX_TRIES actually govern the jobs that get enqueued
        if default_timeout_s is None:
            default_timeout_s = float(os.environ.get("WORKER_JOB_TIMEOUT",
                                                     "3600"))
        if max_tries is None:
            max_tries = int(os.environ.get("WORKER_MAX_TRIES", "1"))
        self.default_timeout_s = default_timeout_s
        self.max_tries = max_tries

    @staticmethod
    def job_id_for_task(task_id: str) -> str:
        return f"ml_{task_id}"

    def enqueue_task(self, task_id: str, task_type: str, video_id: str,
                     video_path: str, config: dict[str, Any] | None = None,
                     priority: int = 5) -> Job | None:
        if task_type not in SUPPORTED_TASK_TYPES:
            raise ValueError(f"unsupported task type: {task_type!r}")
        job = Job(
            job_id=self.job_id_for_task(task_id),
            function=PROCESS_FUNCTION,
            args=[task_id, task_type, video_id, video_path, config or {}],
            queue=ML_QUEUE,
            priority=priority,
            max_tries=self.max_tries,
            timeout_s=self.default_timeout_s,
        )
        result = self.queue.enqueue(job)
        if result is None:
            log.info("job already enqueued (dedup)", extra={"task_id": task_id})
            return None
        # Post-enqueue verification (reference: job_producer.py:124-132).
        if not self.queue.exists_active(job.job_id):
            log.error("enqueue verification failed", extra={"job_id": job.job_id})
        return result

    def job_exists(self, task_id: str) -> bool:
        return self.queue.exists_active(self.job_id_for_task(task_id))

    def abort_task(self, task_id: str) -> bool:
        return self.queue.request_abort(self.job_id_for_task(task_id))
