"""Artifact repository with selection-policy-aware queries.

Copy of eioku_tpu/repositories/artifact_repository.py for the PyTorch port.

Capability parity: backend/src/repositories/artifact_repository.py:17-341:
create (schema-validate -> insert -> projection sync, sync failure non-fatal),
batch_create (validate-all -> bulk insert -> sync-all, rollback on error),
get_by_asset with type/time/payload filters, get_by_span overlap queries, and the
five selection-policy modes (latest / latest_per_language / pinned / profile /
best_quality) applied in SQL.
"""
from __future__ import annotations

import json
import logging
from typing import Any, Callable

from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import PROFILE_QUALITY_ORDER, ArtifactEnvelope, SelectionPolicy
from eioku_tpu_torch.domain.schema_registry import SchemaRegistry
from eioku_tpu_torch.repositories._util import dt_to_str, str_to_dt

log = logging.getLogger(__name__)

_INSERT_SQL = (
    "INSERT INTO artifacts (artifact_id, asset_id, artifact_type, schema_version,"
    " span_start_ms, span_end_ms, payload_json, producer, producer_version,"
    " model_profile, config_hash, input_hash, run_id, created_at)"
    " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
)


def _env_params(a: ArtifactEnvelope) -> tuple:
    return (
        a.artifact_id, a.asset_id, a.artifact_type, a.schema_version,
        a.span_start_ms, a.span_end_ms, json.dumps(a.payload_json), a.producer,
        a.producer_version, a.model_profile, a.config_hash, a.input_hash, a.run_id,
        dt_to_str(a.created_at),
    )


def _row_to_envelope(r) -> ArtifactEnvelope:
    return ArtifactEnvelope(
        artifact_id=r["artifact_id"],
        asset_id=r["asset_id"],
        artifact_type=r["artifact_type"],
        schema_version=r["schema_version"],
        span_start_ms=r["span_start_ms"],
        span_end_ms=r["span_end_ms"],
        payload_json=json.loads(r["payload_json"]),
        producer=r["producer"],
        producer_version=r["producer_version"],
        model_profile=r["model_profile"],
        config_hash=r["config_hash"],
        input_hash=r["input_hash"],
        run_id=r["run_id"],
        created_at=str_to_dt(r["created_at"]),
    )


class ArtifactRepository:
    def __init__(self, db: Database,
                 projection_sync: Callable[[ArtifactEnvelope], None] | None = None):
        self.db = db
        self.projection_sync = projection_sync

    # -- writes ---------------------------------------------------------------

    def create(self, env: ArtifactEnvelope) -> ArtifactEnvelope:
        SchemaRegistry.validate(env.artifact_type, env.schema_version, env.payload_json)
        self.db.execute(_INSERT_SQL, _env_params(env))
        if self.projection_sync is not None:
            try:
                self.projection_sync(env)
            except Exception:
                # Projection failure is non-fatal for a single create; projections
                # are rebuildable (reference: artifact_repository.py:62-68).
                log.exception("projection sync failed", extra={"artifact_id": env.artifact_id})
        return env

    def batch_create(self, envs: list[ArtifactEnvelope]) -> list[ArtifactEnvelope]:
        """Validate all, then insert + sync all inside one transaction (all-or-nothing,
        reference: artifact_repository.py:71-137)."""
        for env in envs:
            SchemaRegistry.validate(env.artifact_type, env.schema_version, env.payload_json)
        with self.db.transaction() as conn:
            conn.executemany(_INSERT_SQL, [_env_params(e) for e in envs])
            if self.projection_sync is not None:
                for env in envs:
                    self.projection_sync(env)
        return envs

    def insert_unchecked(self, env: ArtifactEnvelope) -> ArtifactEnvelope:
        """Insert WITHOUT schema validation or projection sync — for importing
        foreign envelopes whose payload schema we don't register (envelopes
        are the source of truth either way; unknown types have no projection
        handler). Normal writes go through create/batch_create."""
        self.db.execute(_INSERT_SQL, _env_params(env))
        return env

    def insert_unchecked_batch(self, envs: list[ArtifactEnvelope]) -> int:
        """Bulk insert_unchecked in one transaction (the importer's path: the
        final resync_all builds projections once for everything)."""
        with self.db.transaction() as conn:
            conn.executemany(_INSERT_SQL, [_env_params(e) for e in envs])
        return len(envs)

    def delete_for_asset(self, asset_id: str) -> int:
        cur = self.db.execute("DELETE FROM artifacts WHERE asset_id=?", (asset_id,))
        return cur.rowcount

    # -- reads ----------------------------------------------------------------

    def get(self, artifact_id: str) -> ArtifactEnvelope | None:
        r = self.db.query_one("SELECT * FROM artifacts WHERE artifact_id=?", (artifact_id,))
        return _row_to_envelope(r) if r else None

    def get_by_asset(
        self,
        asset_id: str,
        artifact_type: str | None = None,
        start_ms: int | None = None,
        end_ms: int | None = None,
        run_id: str | None = None,
        payload_filters: dict[str, Any] | None = None,
        selection: SelectionPolicy | None = None,
        limit: int = 10000,
        offset: int = 0,
    ) -> list[ArtifactEnvelope]:
        clauses = ["asset_id=?"]
        params: list[Any] = [asset_id]
        if artifact_type is not None:
            clauses.append("artifact_type=?"); params.append(artifact_type)
        if start_ms is not None:
            clauses.append("span_end_ms > ?"); params.append(start_ms)
        if end_ms is not None:
            clauses.append("span_start_ms < ?"); params.append(end_ms)
        if run_id is not None:
            clauses.append("run_id=?"); params.append(run_id)
        if payload_filters:
            for key, value in payload_filters.items():
                # Match either a scalar field or membership in an array field
                # (reference uses JSONB `?` for arrays, artifact_repository.py:173-182).
                d = self.db.dialect
                clauses.append(
                    f"({d.json_field('payload_json')} = ?"
                    f" OR {d.json_array_contains('payload_json')})"
                )
                params.extend([key, value, key, value])
        if selection is not None and run_id is None and artifact_type is not None:
            sel_clause, sel_params = self._selection_clause(asset_id, artifact_type, selection)
            if sel_clause:
                clauses.append(sel_clause)
                params.extend(sel_params)
        sql = (
            "SELECT * FROM artifacts WHERE " + " AND ".join(clauses)
            + " ORDER BY span_start_ms ASC, artifact_id ASC LIMIT ? OFFSET ?"
        )
        params.extend([limit, offset])
        return [_row_to_envelope(r) for r in self.db.query(sql, tuple(params))]

    def count_payload_values(
        self,
        asset_id: str,
        artifact_type: str,
        json_path: str,
        selection: SelectionPolicy | None = None,
    ) -> tuple[list[tuple[Any, int]], int]:
        """SQL-side aggregation: (value, count) pairs of
        json_extract(payload_json, json_path) over the selected artifacts,
        ordered by count desc, plus the total artifact count. Serves the
        jump-options endpoint without materializing thousands of envelopes."""
        clauses = ["asset_id=?", "artifact_type=?"]
        params: list[Any] = [json_path, asset_id, artifact_type]
        if selection is not None:
            sel_clause, sel_params = self._selection_clause(
                asset_id, artifact_type, selection)
            if sel_clause:
                clauses.append(sel_clause)
                params.extend(sel_params)
        sql = (f"SELECT {self.db.dialect.json_path('payload_json')} AS v,"
               " COUNT(*) AS n"
               " FROM artifacts WHERE " + " AND ".join(clauses)
               + " GROUP BY v ORDER BY n DESC, v ASC")
        rows = self.db.query(sql, tuple(params))
        pairs = [(r["v"], int(r["n"])) for r in rows]
        return pairs, sum(n for _, n in pairs)

    def get_by_span(self, asset_id: str, start_ms: int, end_ms: int,
                    artifact_type: str | None = None) -> list[ArtifactEnvelope]:
        return self.get_by_asset(asset_id, artifact_type=artifact_type,
                                 start_ms=start_ms, end_ms=end_ms)

    def list_types_for_asset(self, asset_id: str) -> list[str]:
        rows = self.db.query(
            "SELECT DISTINCT artifact_type FROM artifacts WHERE asset_id=? ORDER BY 1",
            (asset_id,))
        return [r[0] for r in rows]

    def list_profiles(self, asset_id: str, artifact_type: str | None = None) -> list[dict]:
        clauses, params = ["asset_id=?"], [asset_id]
        if artifact_type:
            clauses.append("artifact_type=?"); params.append(artifact_type)
        rows = self.db.query(
            "SELECT model_profile, artifact_type, COUNT(*) AS n, MAX(created_at) AS newest"
            " FROM artifacts WHERE " + " AND ".join(clauses)
            + " GROUP BY model_profile, artifact_type ORDER BY newest DESC",
            tuple(params))
        return [dict(r) for r in rows]

    def list_runs(self, asset_id: str, artifact_type: str | None = None) -> list[dict]:
        """Group artifacts by run with language extraction
        (reference: api/artifact_controller.py:389-450)."""
        clauses, params = ["asset_id=?"], [asset_id]
        if artifact_type:
            clauses.append("artifact_type=?"); params.append(artifact_type)
        rows = self.db.query(
            "SELECT run_id, artifact_type, model_profile, producer, producer_version,"
            " config_hash, COUNT(*) AS artifact_count, MIN(created_at) AS created_at,"
            f" {self.db.dialect.json_field_literal('MIN(payload_json)', 'language')} AS language"
            " FROM artifacts WHERE " + " AND ".join(clauses)
            + " GROUP BY run_id, artifact_type ORDER BY created_at DESC",
            tuple(params))
        return [dict(r) for r in rows]

    # -- selection policies ---------------------------------------------------

    def _selection_clause(self, asset_id: str, artifact_type: str,
                          policy: SelectionPolicy) -> tuple[str, list[Any]]:
        if policy.mode == "pinned":
            return "run_id=?", [policy.run_id]
        if policy.mode == "latest":
            return (
                "run_id = (SELECT run_id FROM artifacts WHERE asset_id=? AND artifact_type=?"
                " ORDER BY created_at DESC, run_id DESC LIMIT 1)",
                [asset_id, artifact_type],
            )
        if policy.mode == "latest_per_language":
            # Newest run per distinct payload language; the SQL is
            # dialect-divergent (PG DISTINCT ON vs SQLite's MAX-row rule,
            # reference: artifact_repository.py:258-287)
            return (self.db.dialect.latest_run_per_language_clause(),
                    [asset_id, artifact_type])
        if policy.mode == "profile":
            return (
                "run_id = (SELECT run_id FROM artifacts WHERE asset_id=? AND artifact_type=?"
                " AND model_profile=? ORDER BY created_at DESC, run_id DESC LIMIT 1)",
                [asset_id, artifact_type, policy.model_profile],
            )
        if policy.mode == "best_quality":
            # Prefer high_quality > balanced > fast, newest within the tier
            # (reference: artifact_repository.py:288-301).
            order = " ".join(
                f"WHEN '{p}' THEN {i}" for i, p in enumerate(PROFILE_QUALITY_ORDER)
            )
            return (
                f"run_id = (SELECT run_id FROM artifacts WHERE asset_id=? AND artifact_type=?"
                f" ORDER BY CASE model_profile {order} ELSE 99 END ASC,"
                f" created_at DESC, run_id DESC LIMIT 1)",
                [asset_id, artifact_type],
            )
        return "", []
