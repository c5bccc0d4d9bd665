"""Copy of eioku_tpu/domain/__init__.py for the PyTorch port."""
from eioku_tpu_torch.domain.artifacts import ArtifactEnvelope, Run, SelectionPolicy
from eioku_tpu_torch.domain.models import PathConfig, Task, TaskStatus, Video, VideoStatus

__all__ = [
    "ArtifactEnvelope",
    "Run",
    "SelectionPolicy",
    "Video",
    "VideoStatus",
    "Task",
    "TaskStatus",
    "PathConfig",
]
