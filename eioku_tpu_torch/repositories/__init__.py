"""Copy of eioku_tpu/repositories/__init__.py for the PyTorch port."""
from eioku_tpu_torch.repositories.artifact_repository import ArtifactRepository
from eioku_tpu_torch.repositories.path_config_repository import PathConfigRepository
from eioku_tpu_torch.repositories.run_repository import RunRepository
from eioku_tpu_torch.repositories.selection_policy_manager import SelectionPolicyManager
from eioku_tpu_torch.repositories.task_repository import TaskRepository
from eioku_tpu_torch.repositories.video_repository import VideoRepository

__all__ = [
    "VideoRepository",
    "TaskRepository",
    "ArtifactRepository",
    "RunRepository",
    "PathConfigRepository",
    "SelectionPolicyManager",
]
