"""Async worker loop executing queued jobs with bounded concurrency.

Copy of eioku_tpu/queue/worker.py for the PyTorch port.

Capability parity with the reference's arq worker configuration
(ml-service/src/main_worker.py:88-152: max_jobs for GPU
serialization, per-job timeout, max_tries, poll_delay, allow_abort;
backend/src/workers/arq_worker.py:26-103: cron scheduling).

Jobs are named async functions invoked as fn(ctx, *args, **kwargs); ctx carries
the job id, attempt count, and an `abort_check` callable the function may poll.
A job raising asyncio.CancelledError records CANCELLED (reference:
task_handler.py:430-446).
"""
from __future__ import annotations

import asyncio
import logging
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from eioku_tpu_torch.queue.jobs import Job, JobStatus

log = logging.getLogger(__name__)

JobFunction = Callable[..., Awaitable[Any]]


@dataclass
class CronJob:
    function: JobFunction
    interval_s: float
    name: str = ""
    run_at_startup: bool = False
    _last_run: float = field(default=0.0, repr=False)


@dataclass
class WorkerSettings:
    queue_name: str = "ml_jobs"
    max_jobs: int = int(os.environ.get("WORKER_MAX_JOBS", "1"))
    # informational mirrors of the enqueue-side knobs: per-job timeout and
    # try budget ride ON THE JOB ROW, stamped by JobProducer (which reads
    # the same WORKER_JOB_TIMEOUT / WORKER_MAX_TRIES env vars), so changing
    # them here does not retroactively affect already-enqueued jobs
    job_timeout_s: float = float(os.environ.get("WORKER_JOB_TIMEOUT", "3600"))
    max_tries: int = int(os.environ.get("WORKER_MAX_TRIES", "1"))
    poll_delay_s: float = 0.1
    abort_poll_s: float = 1.0


class Worker:
    def __init__(self, queue, settings: WorkerSettings | None = None,
                 worker_id: str | None = None, ctx: dict[str, Any] | None = None):
        self.queue = queue
        self.settings = settings or WorkerSettings()
        self.worker_id = worker_id or f"{socket.gethostname()}:{os.getpid()}"
        self.functions: dict[str, JobFunction] = {}
        self.cron_jobs: list[CronJob] = []
        self.ctx: dict[str, Any] = ctx or {}
        self._stopping = asyncio.Event()
        self._active: set[asyncio.Task] = set()
        self.jobs_completed = 0
        self.jobs_failed = 0

    def register(self, name: str, fn: JobFunction) -> None:
        self.functions[name] = fn

    def add_cron(self, fn: JobFunction, interval_s: float, name: str = "",
                 run_at_startup: bool = False) -> None:
        self.cron_jobs.append(CronJob(fn, interval_s, name or fn.__name__, run_at_startup))

    def stop(self) -> None:
        self._stopping.set()

    async def run(self, max_iterations: int | None = None) -> None:
        """Main loop. max_iterations bounds the loop for tests; None = run forever."""
        sem = asyncio.Semaphore(self.settings.max_jobs)
        iterations = 0
        for cron in self.cron_jobs:
            if cron.run_at_startup:
                await self._run_cron(cron)
        while not self._stopping.is_set():
            if max_iterations is not None and iterations >= max_iterations:
                break
            iterations += 1
            await self._tick_cron()
            if sem.locked():
                await asyncio.sleep(self.settings.poll_delay_s)
                continue
            job = self.queue.claim(self.worker_id, self.settings.queue_name)
            if job is None:
                if max_iterations is None:
                    await asyncio.sleep(self.settings.poll_delay_s)
                elif self._active:
                    await asyncio.sleep(0)  # let active jobs progress in tests
                continue
            await sem.acquire()
            task = asyncio.create_task(self._execute(job, sem))
            self._active.add(task)
            task.add_done_callback(self._active.discard)
        if self._active:
            await asyncio.gather(*self._active, return_exceptions=True)

    async def drain(self) -> None:
        """Process jobs until the queue is empty and all executions finished."""
        while True:
            counts = self.queue.counts(self.settings.queue_name)
            pending = counts.get("queued", 0) + counts.get("running", 0)
            if pending == 0 and not self._active:
                return
            await self.run(max_iterations=max(pending, 1) * 4)
            await asyncio.sleep(0)
            if self._active:
                await asyncio.gather(*self._active, return_exceptions=True)

    async def _tick_cron(self) -> None:
        now = time.monotonic()
        for cron in self.cron_jobs:
            if now - cron._last_run >= cron.interval_s:
                cron._last_run = now
                await self._run_cron(cron)

    async def _run_cron(self, cron: CronJob) -> None:
        try:
            await cron.function(self.ctx)
        except Exception:
            log.exception("cron job failed", extra={"cron": cron.name})

    async def _execute(self, job: Job, sem: asyncio.Semaphore) -> None:
        try:
            fn = self.functions.get(job.function)
            if fn is None:
                self.queue.fail(job.job_id, f"unknown function {job.function!r}")
                self.jobs_failed += 1
                return
            ctx = dict(self.ctx)
            ctx.update({
                "job_id": job.job_id,
                "attempt": job.attempts,
                "worker_id": self.worker_id,
                "abort_check": lambda: self.queue.is_abort_requested(job.job_id),
            })
            inner = asyncio.ensure_future(fn(ctx, *job.args, **job.kwargs))
            watcher = asyncio.ensure_future(self._watch_abort(job.job_id, inner))
            try:
                result = await asyncio.wait_for(inner, timeout=job.timeout_s)
                self.queue.complete(job.job_id, result)
                self.jobs_completed += 1
            except asyncio.CancelledError:
                self.queue.cancel(job.job_id)
                log.info("job cancelled", extra={"job_id": job.job_id})
            except asyncio.TimeoutError:
                status = self.queue.fail(job.job_id, f"timeout after {job.timeout_s}s")
                self.jobs_failed += status is JobStatus.FAILED
                log.error("job timed out", extra={"job_id": job.job_id})
            except Exception as e:
                status = self.queue.fail(job.job_id, f"{type(e).__name__}: {e}")
                self.jobs_failed += status is JobStatus.FAILED
                log.exception("job failed", extra={"job_id": job.job_id})
            finally:
                watcher.cancel()
        finally:
            sem.release()

    async def _watch_abort(self, job_id: str, inner: asyncio.Future) -> None:
        """Cooperatively cancel the job task when an abort is requested."""
        try:
            while not inner.done():
                if self.queue.is_abort_requested(job_id):
                    inner.cancel()
                    return
                await asyncio.sleep(self.settings.abort_poll_s)
        except asyncio.CancelledError:
            pass
