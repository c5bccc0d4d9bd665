"""Copy of eioku_tpu/repositories/_util.py for the PyTorch port."""
from __future__ import annotations

from datetime import datetime


def dt_to_str(dt: datetime | None) -> str | None:
    return dt.isoformat() if dt is not None else None


def str_to_dt(s: str | None) -> datetime | None:
    return datetime.fromisoformat(s) if s else None
