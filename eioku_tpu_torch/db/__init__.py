"""Copy of eioku_tpu/db/__init__.py for the PyTorch port."""
from eioku_tpu_torch.db.connection import Database, get_database, set_database
from eioku_tpu_torch.db.migrations import run_migrations

__all__ = ["Database", "get_database", "set_database", "run_migrations"]
