"""Copy of eioku_tpu/queue/__init__.py for the PyTorch port."""
from eioku_tpu_torch.queue.jobs import Job, JobStatus
from eioku_tpu_torch.queue.producer import JobProducer
from eioku_tpu_torch.queue.queue import MemoryJobQueue, SqliteJobQueue
from eioku_tpu_torch.queue.worker import CronJob, Worker, WorkerSettings

__all__ = [
    "Job",
    "JobStatus",
    "SqliteJobQueue",
    "MemoryJobQueue",
    "JobProducer",
    "Worker",
    "WorkerSettings",
    "CronJob",
]
