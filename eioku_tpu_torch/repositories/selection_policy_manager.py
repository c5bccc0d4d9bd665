"""Persisted per-(asset, artifact_type) selection policies.

Copy of eioku_tpu/repositories/selection_policy_manager.py for the PyTorch port.

Capability parity: backend/src/repositories/selection_policy_manager.py:14-137
(default policy = latest).
"""
from __future__ import annotations

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import SelectionPolicy, utcnow
from eioku_tpu_torch.repositories._util import dt_to_str


class SelectionPolicyManager:
    def __init__(self, db: Database):
        self.db = db

    def get_policy(self, asset_id: str, artifact_type: str) -> SelectionPolicy:
        r = self.db.query_one(
            "SELECT mode, run_id, model_profile FROM artifact_selections"
            " WHERE asset_id=? AND artifact_type=?",
            (asset_id, artifact_type))
        if r is None:
            return SelectionPolicy.default()
        return SelectionPolicy(mode=r["mode"], run_id=r["run_id"],
                               model_profile=r["model_profile"])

    def set_policy(self, asset_id: str, artifact_type: str, policy: SelectionPolicy) -> None:
        self.db.execute(
            "INSERT INTO artifact_selections (asset_id, artifact_type, mode, run_id,"
            " model_profile, updated_at) VALUES (?,?,?,?,?,?)"
            " ON CONFLICT(asset_id, artifact_type) DO UPDATE SET mode=excluded.mode,"
            " run_id=excluded.run_id, model_profile=excluded.model_profile,"
            " updated_at=excluded.updated_at",
            (asset_id, artifact_type, policy.mode, policy.run_id, policy.model_profile,
             dt_to_str(utcnow())),
        )

    def clear_policy(self, asset_id: str, artifact_type: str) -> bool:
        cur = self.db.execute(
            "DELETE FROM artifact_selections WHERE asset_id=? AND artifact_type=?",
            (asset_id, artifact_type))
        return cur.rowcount > 0
