"""Run repository.

Copy of eioku_tpu/repositories/run_repository.py for the PyTorch port.

Capability parity: backend/src/repositories/run_repository.py:14-120.
"""
from __future__ import annotations

import json

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import Run
from eioku_tpu_torch.repositories._util import dt_to_str, str_to_dt


def _row_to_run(r) -> Run:
    return Run(
        run_id=r["run_id"],
        asset_id=r["asset_id"],
        task_type=r["task_type"],
        producer=r["producer"],
        producer_version=r["producer_version"],
        model_profile=r["model_profile"],
        config_hash=r["config_hash"],
        input_hash=r["input_hash"],
        created_at=str_to_dt(r["created_at"]),
        config_json=json.loads(r["config_json"]),
    )


class RunRepository:
    def __init__(self, db: Database):
        self.db = db

    def save(self, run: Run) -> Run:
        self.db.execute(
            self.db.dialect.upsert(
                "runs", ["run_id", "asset_id", "task_type", "producer",
                         "producer_version", "model_profile", "config_hash",
                         "input_hash", "created_at", "config_json"],
                ["run_id"]),
            (run.run_id, run.asset_id, run.task_type, run.producer, run.producer_version,
             run.model_profile, run.config_hash, run.input_hash, dt_to_str(run.created_at),
             json.dumps(run.config_json)),
        )
        return run

    def get(self, run_id: str) -> Run | None:
        r = self.db.query_one("SELECT * FROM runs WHERE run_id=?", (run_id,))
        return _row_to_run(r) if r else None

    def list_for_asset(self, asset_id: str, task_type: str | None = None) -> list[Run]:
        if task_type:
            rows = self.db.query(
                "SELECT * FROM runs WHERE asset_id=? AND task_type=? ORDER BY created_at DESC",
                (asset_id, task_type))
        else:
            rows = self.db.query(
                "SELECT * FROM runs WHERE asset_id=? ORDER BY created_at DESC", (asset_id,))
        return [_row_to_run(r) for r in rows]
