"""eioku_tpu_torch — the PyTorch/CUDA port of eioku_tpu for NVIDIA GPUs."""

__version__ = "0.1.0"
