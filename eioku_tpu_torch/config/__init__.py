"""Copy of eioku_tpu/config/__init__.py for the PyTorch port."""
from eioku_tpu_torch.config.settings import AppConfig, load_config

__all__ = ["AppConfig", "load_config"]
