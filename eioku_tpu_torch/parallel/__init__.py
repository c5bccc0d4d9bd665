"""Batch-parallel inference over several devices, training, and the
multi-device serving layer: mesh and process group, pipeline parallelism
(port of eioku_tpu/parallel/)."""
from eioku_tpu_torch.parallel.mesh import make_mesh, shard_minilm_params, shard_yolo_params

__all__ = ["make_mesh", "shard_minilm_params", "shard_yolo_params"]
