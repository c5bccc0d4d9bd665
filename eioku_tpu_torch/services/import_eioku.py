"""Import a reference eioku database: videos, artifacts, runs, selections.

Copy of eioku_tpu/services/import_eioku.py for the PyTorch port.

docs/MIGRATION.md recommends a re-index (artifacts are regenerable), but a
library that took days of GPU time — or carries hand-pinned selections — is
worth carrying over. This reads the reference's SQLAlchemy schema
(backend/src/database/models.py: videos, artifacts, runs,
artifact_selections, path_configs) straight from its SQLite file and maps
rows onto our domain objects. PostgreSQL libraries: `pg_dump`, load into a
scratch SQLite with pgloader/your tool of choice, then import — or just
re-index.

Projections (scene_ranges, object_labels, transcript FTS, ...) are NOT
imported: both stacks treat them as rebuildable from envelopes, so the
importer finishes with a full projection resync instead of trusting the
source's derived tables.

Idempotent: existing ids are skipped, so a partial import can simply be
re-run. Invoke via `python -m eioku_tpu_torch.cli import-eioku --source eioku.db`.
"""
from __future__ import annotations

import json
import logging
import os
import sqlite3
from datetime import datetime, timezone

from eioku_tpu_torch.domain.artifacts import (
    ArtifactEnvelope,
    Run,
    SelectionPolicy,
    utcnow,
)
from eioku_tpu_torch.domain.models import PathConfig, Video, VideoStatus
from eioku_tpu_torch.domain.schema_registry import SchemaRegistry
from eioku_tpu_torch.domain.task_registry import TASK_REGISTRY

log = logging.getLogger(__name__)

_VIDEO_STATUS = {"pending": VideoStatus.DISCOVERED,
                 "processing": VideoStatus.PROCESSING,
                 "completed": VideoStatus.PROCESSED,
                 "processed": VideoStatus.PROCESSED,
                 "failed": VideoStatus.FAILED}

# artifact_type -> our task_type (for synthesizing Run rows; the reference's
# runs table has no task_type column — its pipeline_profile maps to
# model_profile). First-wins so the dedicated tasks beat the multi-type
# visual_analysis umbrella.
_TASK_FOR_ARTIFACT: dict[str, str] = {}
for _spec in TASK_REGISTRY.values():
    if _spec.name == "visual_analysis":
        continue
    for _a in _spec.artifact_types:
        _TASK_FOR_ARTIFACT.setdefault(_a, _spec.name)


def _parse_dt(raw) -> datetime | None:
    """Reference timestamps are SQLAlchemy-written ('YYYY-MM-DD HH:MM:SS[.ffffff]')
    or ISO-8601; both parse with fromisoformat after normalizing and are
    naive-UTC by the reference's convention."""
    if raw is None or raw == "":
        return None
    if isinstance(raw, (int, float)):
        return datetime.fromtimestamp(raw, tz=timezone.utc).replace(tzinfo=None)
    s = str(raw).replace("T", " ").replace("Z", "").strip()
    try:
        return datetime.fromisoformat(s)
    except ValueError:
        return None


def _payload(raw) -> dict:
    if isinstance(raw, dict):
        return raw
    try:
        out = json.loads(raw) if raw is not None else {}
        return out if isinstance(out, dict) else {"value": out}
    except (TypeError, ValueError):
        return {}


def _table_names(conn: sqlite3.Connection) -> set[str]:
    return {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")}


def import_reference_db(ctx, source_path: str, rehash: bool = True) -> dict:
    """Import from a reference SQLite file into ctx's database. Returns counts.

    rehash: recompute our xxhash64 for files that still exist on disk (the
    reference stores SHA-256; discovery dedup here keys on xxhash64). Missing
    files keep the source hash — still unique, still a valid identity.
    """
    if not os.path.isfile(source_path):
        raise FileNotFoundError(source_path)
    src = sqlite3.connect(f"file:{source_path}?mode=ro", uri=True)
    src.row_factory = sqlite3.Row
    tables = _table_names(src)
    for required in ("videos", "artifacts"):
        if required not in tables:
            raise ValueError(
                f"{source_path} has no '{required}' table — not a reference "
                f"eioku database (tables: {sorted(tables)})")
    counts = {"videos": 0, "artifacts": 0, "runs": 0, "selections": 0,
              "paths": 0, "skipped_existing": 0, "unvalidated": 0}

    # -- videos ---------------------------------------------------------------
    ours = ctx.videos.list(limit=1_000_000)
    existing_videos = {v.id for v in ours}
    # videos.path is UNIQUE here: a file this stack already discovered under
    # its own id must not be re-inserted under the reference's id
    existing_paths = {v.path for v in ours}
    for r in src.execute("SELECT * FROM videos"):
        if r["video_id"] in existing_videos or r["file_path"] in existing_paths:
            counts["skipped_existing"] += 1
            continue
        file_hash = r["file_hash"] or ""
        if rehash and os.path.isfile(r["file_path"]):
            from eioku_tpu_torch.utils.hashing import hash_file
            file_hash = hash_file(r["file_path"])
        dur = r["duration"]
        ctx.videos.save(Video(
            id=r["video_id"], path=r["file_path"], file_hash=file_hash,
            size_bytes=int(r["file_size"] or 0),
            duration_ms=int(dur * 1000) if dur is not None else None,
            status=_VIDEO_STATUS.get(r["status"], VideoStatus.DISCOVERED),
            created_at=_parse_dt(r["created_at"]) or utcnow(),
            file_created_at=_parse_dt(r["file_created_at"]),
            processed_at=_parse_dt(r["processed_at"])))
        counts["videos"] += 1

    # -- artifacts (validated ones via the repo; unknown types via raw insert
    #    so foreign payload schemas still survive the migration) --------------
    have = {row["artifact_id"] for row in
            ctx.db.query("SELECT artifact_id FROM artifacts")}
    valid_batch: list[ArtifactEnvelope] = []
    run_meta: dict[str, dict] = {}  # run_id -> first artifact's provenance
    for r in src.execute("SELECT * FROM artifacts ORDER BY created_at"):
        env = ArtifactEnvelope(
            artifact_id=r["artifact_id"], asset_id=r["asset_id"],
            artifact_type=r["artifact_type"],
            schema_version=int(r["schema_version"] or 1),
            span_start_ms=int(r["span_start_ms"] or 0),
            span_end_ms=int(r["span_end_ms"] or 0),
            payload_json=_payload(r["payload_json"]),
            producer=r["producer"] or "eioku-import",
            producer_version=r["producer_version"] or "0",
            model_profile=r["model_profile"] or "balanced",
            config_hash=r["config_hash"] or "", input_hash=r["input_hash"] or "",
            run_id=r["run_id"],
            created_at=_parse_dt(r["created_at"]) or utcnow())
        # run provenance comes from EVERY source artifact (before the dedup
        # skip): a crashed earlier import may have committed artifacts whose
        # Run rows were never synthesized — re-running must repair them
        run_meta.setdefault(env.run_id, {
            "asset_id": env.asset_id, "artifact_type": env.artifact_type,
            "producer": env.producer, "producer_version": env.producer_version,
            "model_profile": env.model_profile, "config_hash": env.config_hash,
            "input_hash": env.input_hash, "created_at": env.created_at})
        if env.artifact_id in have:
            counts["skipped_existing"] += 1
            continue
        ok = False
        if SchemaRegistry.is_registered(env.artifact_type, env.schema_version):
            try:
                SchemaRegistry.validate(env.artifact_type, env.schema_version,
                                        env.payload_json)
                ok = True
            except Exception:
                pass  # schema drift: keep the envelope, skip projections
        if not ok:
            counts["unvalidated"] += 1
        valid_batch.append(env)
    # all envelopes insert WITHOUT per-row projection sync: the import ends
    # with a full resync_all, so syncing here would build every projection
    # twice on exactly the libraries big enough to make import worthwhile
    for i in range(0, len(valid_batch), 500):
        counts["artifacts"] += ctx.artifacts.insert_unchecked_batch(
            valid_batch[i:i + 500])

    # -- runs (source rows where present; provenance from the artifacts,
    #    which is where the reference actually stores it) ---------------------
    existing_runs = {row["run_id"] for row in
                     ctx.db.query("SELECT run_id FROM runs")}
    src_runs = {}
    if "runs" in tables:
        src_runs = {r["run_id"]: r for r in src.execute("SELECT * FROM runs")}
    for run_id, meta in run_meta.items():
        if run_id in existing_runs:
            counts["skipped_existing"] += 1
            continue
        sr = src_runs.get(run_id)
        task_type = _TASK_FOR_ARTIFACT.get(
            meta["artifact_type"], meta["artifact_type"].split(".")[0])
        ctx.runs.save(Run(
            run_id=run_id, asset_id=meta["asset_id"], task_type=task_type,
            producer=meta["producer"], producer_version=meta["producer_version"],
            model_profile=(sr["pipeline_profile"] if sr else None)
            or meta["model_profile"],
            config_hash=meta["config_hash"], input_hash=meta["input_hash"],
            created_at=(_parse_dt(sr["started_at"]) if sr else None)
            or meta["created_at"]))
        counts["runs"] += 1

    # -- selections ------------------------------------------------------------
    if "artifact_selections" in tables:
        for r in src.execute("SELECT * FROM artifact_selections"):
            # the reference persists mode "default" verbatim (its fallback
            # policy = newest run), which our SelectionPolicy spells "latest"
            mode = r["selection_mode"] or "latest"
            if mode == "default":
                mode = "latest"
            try:
                policy = SelectionPolicy(mode=mode,
                                         run_id=r["pinned_run_id"],
                                         model_profile=r["preferred_profile"])
            except ValueError:
                log.warning("skipping selection with unknown mode %r for "
                            "(%s, %s)", mode, r["asset_id"],
                            r["artifact_type"])
                continue
            ctx.policies.set_policy(r["asset_id"], r["artifact_type"], policy)
            counts["selections"] += 1

    # -- path configs ------------------------------------------------------------
    if "path_configs" in tables:
        existing_paths = {p.path for p in ctx.paths.list()}
        for r in src.execute("SELECT * FROM path_configs"):
            if r["path"] in existing_paths:
                counts["skipped_existing"] += 1
                continue
            ctx.paths.save(PathConfig(
                path=r["path"],
                recursive=str(r["recursive"]).lower() != "false"))
            counts["paths"] += 1

    src.close()
    # projections are rebuilt, never trusted from the source DB
    counts["projected"] = ctx.projection_sync.resync_all()
    log.info("imported reference library", extra=counts)
    return counts
