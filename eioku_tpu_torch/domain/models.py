"""Pure domain objects for videos, tasks, and configured paths.

Copy of eioku_tpu/domain/models.py for the PyTorch port.

Capability parity: backend/src/domain/models.py:4-132 (Video/Task/
PathConfig with status transitions, priority, per-language tasks).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any

from eioku_tpu_torch.domain.artifacts import new_id, utcnow


class VideoStatus(str, enum.Enum):
    DISCOVERED = "discovered"
    PROCESSING = "processing"
    PROCESSED = "processed"
    FAILED = "failed"
    MISSING = "missing"


class TaskStatus(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


# Legal task status transitions; retry resets failed/cancelled back to pending
# (reference: backend/src/api/task_routes.py:288-361). COMPLETED -> PENDING
# covers deliberate re-runs — semantic re-indexing after a new transcript
# lands, or re-processing with new settings; every run keeps full provenance
# under its own run_id, so re-running never loses history.
_TASK_TRANSITIONS: dict[TaskStatus, set[TaskStatus]] = {
    TaskStatus.PENDING: {TaskStatus.RUNNING, TaskStatus.CANCELLED},
    TaskStatus.RUNNING: {TaskStatus.COMPLETED, TaskStatus.FAILED, TaskStatus.CANCELLED,
                         TaskStatus.PENDING},  # PENDING = reconciler reset
    TaskStatus.FAILED: {TaskStatus.PENDING},
    TaskStatus.CANCELLED: {TaskStatus.PENDING},
    TaskStatus.COMPLETED: {TaskStatus.PENDING},
}


@dataclass
class Video:
    path: str
    id: str = field(default_factory=new_id)
    file_hash: str = ""
    size_bytes: int = 0
    duration_ms: int | None = None
    status: VideoStatus = VideoStatus.DISCOVERED
    created_at: datetime = field(default_factory=utcnow)
    file_created_at: datetime | None = None
    processed_at: datetime | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "path": self.path,
            "file_hash": self.file_hash,
            "size_bytes": self.size_bytes,
            "duration_ms": self.duration_ms,
            "status": self.status.value,
            "created_at": self.created_at.isoformat(),
            "file_created_at": self.file_created_at.isoformat() if self.file_created_at else None,
            "processed_at": self.processed_at.isoformat() if self.processed_at else None,
        }


@dataclass
class Task:
    video_id: str
    task_type: str
    id: str = field(default_factory=new_id)
    status: TaskStatus = TaskStatus.PENDING
    priority: int = 5  # 1 = highest
    language: str | None = None
    config: dict[str, Any] = field(default_factory=dict)
    error: str | None = None
    created_at: datetime = field(default_factory=utcnow)
    started_at: datetime | None = None
    completed_at: datetime | None = None
    attempts: int = 0
    progress: float | None = None  # fractional completion while running

    def can_transition(self, to: TaskStatus) -> bool:
        return to in _TASK_TRANSITIONS[self.status]

    def transition(self, to: TaskStatus) -> None:
        if not self.can_transition(to):
            raise ValueError(f"illegal task transition {self.status.value} -> {to.value}")
        self.status = to
        now = utcnow()
        if to is TaskStatus.RUNNING:
            self.started_at = now
            self.attempts += 1
            self.progress = 0.0
        elif to is TaskStatus.COMPLETED:
            self.completed_at = now
            self.progress = 1.0
        elif to in (TaskStatus.FAILED, TaskStatus.CANCELLED):
            self.completed_at = now
        elif to is TaskStatus.PENDING:
            self.started_at = None
            self.completed_at = None
            self.error = None
            self.progress = None

    @property
    def running_time_s(self) -> float | None:
        if self.started_at is None:
            return None
        end = self.completed_at or utcnow()
        return (end - self.started_at).total_seconds()

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "video_id": self.video_id,
            "task_type": self.task_type,
            "status": self.status.value,
            "priority": self.priority,
            "language": self.language,
            "config": self.config,
            "error": self.error,
            "created_at": self.created_at.isoformat(),
            "started_at": self.started_at.isoformat() if self.started_at else None,
            "completed_at": self.completed_at.isoformat() if self.completed_at else None,
            "attempts": self.attempts,
            "progress": self.progress,
            "running_time_s": self.running_time_s,
        }


@dataclass
class PathConfig:
    path: str
    id: str = field(default_factory=new_id)
    recursive: bool = True
    enabled: bool = True
    created_at: datetime = field(default_factory=utcnow)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "path": self.path,
            "recursive": self.recursive,
            "enabled": self.enabled,
            "created_at": self.created_at.isoformat(),
        }
