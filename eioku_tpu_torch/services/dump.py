"""Library backup & restore: the whole library as one portable dump file.

Copy of eioku_tpu/services/dump.py for the PyTorch port.

Format: gzip-compressed JSON Lines. First line is a header record
(`{"kind": "header", "format": "eioku-tpu-dump", "version": 1, ...}`);
every following line is `{"kind": <record-type>, "data": {...}}` with
record types `path_config`, `video`, `task`, `run`, `selection`, `artifact`.

Scope decisions (mirroring the resync philosophy of
backend/src/commands/resync_projections.py:14-73 — derived
state is never dumped, always rebuilt):
  * projections (FTS, scene_ranges, object_labels, ...) are NOT exported;
    restore ends with one projection_sync.resync_all().
  * `embedding.chunk` artifacts are NOT exported by default: their
    `index_slot` points into this installation's vector file, which the dump
    does not carry. Restore re-enqueues semantic_indexing per video instead
    (pass reindex=False to skip), re-embedding from the restored transcripts.
  * queue jobs are not exported — tasks are the durable unit (restored
    pending work is re-enqueued by the reconciler, exactly like crash
    recovery).

Restore is idempotent: existing ids/paths are skipped, so a partial restore
can simply be re-run (same contract as services/import_eioku.py).

Artifacts stream in rowid-keyed batches both ways, so a multi-million-row
library never materializes in memory.
"""
from __future__ import annotations

import gzip
import json
import logging
import os
from typing import Iterator

from eioku_tpu_torch.domain.artifacts import (
    ArtifactEnvelope,
    Run,
    SelectionPolicy,
    utcnow,
)
from eioku_tpu_torch.domain.models import PathConfig, Task, TaskStatus, Video, VideoStatus
from eioku_tpu_torch.repositories._util import str_to_dt

log = logging.getLogger(__name__)

FORMAT = "eioku-tpu-dump"
VERSION = 1
_BATCH = 500


def _open_out(path: str):
    if path == "-":
        import sys
        return sys.stdout
    return gzip.open(path, "wt", encoding="utf-8") if path.endswith(".gz") \
        else open(path, "w", encoding="utf-8")


def _open_in(path: str):
    if path == "-":
        import sys
        return sys.stdin
    # sniff gzip by magic, not by extension — dumps get renamed
    with open(path, "rb") as f:
        magic = f.read(2)
    return gzip.open(path, "rt", encoding="utf-8") if magic == b"\x1f\x8b" \
        else open(path, "r", encoding="utf-8")


def _iter_artifact_rows(db, include_embeddings: bool) -> Iterator[dict]:
    """Stream artifacts in batches without loading the table. Keyset
    pagination on the artifact_id PRIMARY KEY — portable across both
    dialects (PostgreSQL tables have no implicit rowid)."""
    last = ""
    clause = "" if include_embeddings else \
        " AND artifact_type != 'embedding.chunk'"
    while True:
        rows = db.query(
            f"SELECT * FROM artifacts WHERE artifact_id > ?{clause}"
            " ORDER BY artifact_id LIMIT ?", (last, _BATCH))
        if not rows:
            return
        for r in rows:
            last = r["artifact_id"]
            yield {k: r[k] for k in r.keys()}
        if len(rows) < _BATCH:
            return


def export_dump(ctx, out_path: str, include_embeddings: bool = False) -> dict:
    """Write the library to `out_path` (.gz → compressed; '-' → stdout)."""
    counts = {"videos": 0, "tasks": 0, "runs": 0, "artifacts": 0,
              "selections": 0, "paths": 0}

    def rec(kind: str, data: dict) -> str:
        return json.dumps({"kind": kind, "data": data},
                          separators=(",", ":")) + "\n"

    out = _open_out(out_path)
    try:
        out.write(rec("header", {
            "format": FORMAT, "version": VERSION,
            "created_at": utcnow().isoformat(),
            "include_embeddings": include_embeddings}))
        for p in ctx.paths.list():
            out.write(rec("path_config", p.to_dict()))
            counts["paths"] += 1
        for v in ctx.videos.list(limit=10_000_000):
            out.write(rec("video", v.to_dict()))
            counts["videos"] += 1
        for t in ctx.tasks.find(limit=10_000_000, descending=False):
            d = t.to_dict()
            d.pop("running_time_s", None)  # derived
            out.write(rec("task", d))
            counts["tasks"] += 1
        for r in ctx.db.query("SELECT * FROM runs ORDER BY created_at"):
            out.write(rec("run", {k: r[k] for k in r.keys()}))
            counts["runs"] += 1
        for r in ctx.db.query("SELECT * FROM artifact_selections"):
            out.write(rec("selection", {k: r[k] for k in r.keys()}))
            counts["selections"] += 1
        for row in _iter_artifact_rows(ctx.db, include_embeddings):
            row["payload_json"] = json.loads(row["payload_json"])
            out.write(rec("artifact", row))
            counts["artifacts"] += 1
    finally:
        if out_path != "-":
            out.close()
    log.info("exported library dump", extra=dict(counts, path=out_path))
    return counts


def _video_from(d: dict) -> Video:
    return Video(
        id=d["id"], path=d["path"], file_hash=d.get("file_hash") or "",
        size_bytes=int(d.get("size_bytes") or 0),
        duration_ms=d.get("duration_ms"),
        status=VideoStatus(d.get("status", "discovered")),
        created_at=str_to_dt(d.get("created_at")) or utcnow(),
        file_created_at=str_to_dt(d.get("file_created_at")),
        processed_at=str_to_dt(d.get("processed_at")))


def _task_from(d: dict) -> Task:
    return Task(
        id=d["id"], video_id=d["video_id"], task_type=d["task_type"],
        status=TaskStatus(d.get("status", "pending")),
        priority=int(d.get("priority", 5)), language=d.get("language"),
        config=d.get("config") or {}, error=d.get("error"),
        created_at=str_to_dt(d.get("created_at")) or utcnow(),
        started_at=str_to_dt(d.get("started_at")),
        completed_at=str_to_dt(d.get("completed_at")),
        attempts=int(d.get("attempts", 0)), progress=d.get("progress"))


def _envelope_from(d: dict) -> ArtifactEnvelope:
    return ArtifactEnvelope(
        artifact_id=d["artifact_id"], asset_id=d["asset_id"],
        artifact_type=d["artifact_type"],
        schema_version=int(d.get("schema_version", 1)),
        span_start_ms=int(d.get("span_start_ms", 0)),
        span_end_ms=int(d.get("span_end_ms", 0)),
        payload_json=d["payload_json"],
        producer=d.get("producer") or "eioku-dump",
        producer_version=d.get("producer_version") or "0",
        model_profile=d.get("model_profile") or "balanced",
        config_hash=d.get("config_hash") or "",
        input_hash=d.get("input_hash") or "",
        run_id=d["run_id"],
        created_at=str_to_dt(d.get("created_at")) or utcnow())


def import_dump(ctx, in_path: str, reindex: bool = True) -> dict:
    """Restore a dump into ctx's database (idempotent), rebuild projections,
    and (by default) re-enqueue semantic_indexing for videos with restored
    transcript/OCR text so the vector index is rebuilt on this installation."""
    if in_path != "-" and not os.path.isfile(in_path):
        raise FileNotFoundError(in_path)
    counts = {"videos": 0, "tasks": 0, "runs": 0, "artifacts": 0,
              "selections": 0, "paths": 0, "skipped_existing": 0}

    existing_videos = {v.id for v in ctx.videos.list(limit=10_000_000)}
    existing_video_paths = {v.path for v in ctx.videos.list(limit=10_000_000)}
    existing_paths = {p.path for p in ctx.paths.list()}
    existing_tasks = {r["id"] for r in ctx.db.query("SELECT id FROM tasks")}
    existing_runs = {r["run_id"] for r in ctx.db.query("SELECT run_id FROM runs")}
    have_artifacts = {r["artifact_id"] for r in
                      ctx.db.query("SELECT artifact_id FROM artifacts")}
    text_assets: set[str] = set()  # restored videos with embeddable text
    scene_assets: set[str] = set()  # restored videos with scene keyframes
    batch: list[ArtifactEnvelope] = []

    def flush() -> None:
        if batch:
            counts["artifacts"] += ctx.artifacts.insert_unchecked_batch(batch)
            batch.clear()

    f = _open_in(in_path)
    try:
        first = next(iter(f), None)
        if first is None:
            raise ValueError(f"{in_path} is empty — not an {FORMAT} file")
        header = json.loads(first)
        if header.get("kind") != "header" or \
                header.get("data", {}).get("format") != FORMAT:
            raise ValueError(f"{in_path} is not an {FORMAT} file")
        if int(header["data"].get("version", 0)) > VERSION:
            raise ValueError(
                f"dump version {header['data']['version']} is newer than "
                f"this build supports ({VERSION})")
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            kind, d = obj["kind"], obj["data"]
            if kind == "path_config":
                if d["path"] in existing_paths:
                    counts["skipped_existing"] += 1
                    continue
                ctx.paths.save(PathConfig(
                    path=d["path"], recursive=bool(d.get("recursive", True)),
                    enabled=bool(d.get("enabled", True))))
                counts["paths"] += 1
            elif kind == "video":
                if d["id"] in existing_videos \
                        or d["path"] in existing_video_paths:
                    counts["skipped_existing"] += 1
                    continue
                ctx.videos.save(_video_from(d))
                existing_videos.add(d["id"])
                existing_video_paths.add(d["path"])
                counts["videos"] += 1
            elif kind == "task":
                if d["id"] in existing_tasks \
                        or d["video_id"] not in existing_videos:
                    counts["skipped_existing"] += 1
                    continue
                ctx.tasks.save(_task_from(d))
                counts["tasks"] += 1
            elif kind == "run":
                # runs/selections/artifacts for a video that was NOT restored
                # (path collision with a different local id) would be orphans:
                # projected into search but 404 on /videos/{id} — skip them
                if d["run_id"] in existing_runs \
                        or d["asset_id"] not in existing_videos:
                    counts["skipped_existing"] += 1
                    continue
                ctx.runs.save(Run(
                    run_id=d["run_id"], asset_id=d["asset_id"],
                    task_type=d["task_type"], producer=d["producer"],
                    producer_version=d["producer_version"],
                    model_profile=d["model_profile"],
                    config_hash=d["config_hash"], input_hash=d["input_hash"],
                    created_at=str_to_dt(d.get("created_at")) or utcnow(),
                    config_json=json.loads(d["config_json"])
                    if isinstance(d.get("config_json"), str)
                    else d.get("config_json") or {}))
                counts["runs"] += 1
            elif kind == "selection":
                if d["asset_id"] not in existing_videos:
                    counts["skipped_existing"] += 1
                    continue
                try:
                    policy = SelectionPolicy(
                        mode=d.get("mode") or "latest",
                        run_id=d.get("run_id"),
                        model_profile=d.get("model_profile"))
                except ValueError:
                    log.warning("skipping selection with unknown mode %r",
                                d.get("mode"))
                    continue
                ctx.policies.set_policy(d["asset_id"], d["artifact_type"],
                                        policy)
                counts["selections"] += 1
            elif kind == "artifact":
                if d["artifact_id"] in have_artifacts \
                        or d["asset_id"] not in existing_videos:
                    counts["skipped_existing"] += 1
                    continue
                env = _envelope_from(d)
                if env.artifact_type in ("transcript.segment", "ocr.text"):
                    text_assets.add(env.asset_id)
                elif env.artifact_type == "scene":
                    scene_assets.add(env.asset_id)
                batch.append(env)
                if len(batch) >= _BATCH:
                    flush()
        flush()
    finally:
        if in_path != "-":
            f.close()
    # derived state is rebuilt, never trusted from the dump
    counts["projected"] = ctx.projection_sync.resync_all()
    if reindex:
        counts["reindex_enqueued"] = \
            _enqueue_reindex(ctx, text_assets, "semantic_indexing") + \
            _enqueue_reindex(ctx, scene_assets, "visual_indexing")
    log.info("restored library dump", extra=dict(counts, path=in_path))
    return counts


def _enqueue_reindex(ctx, asset_ids: set[str], task_type: str) -> int:
    if task_type == "visual_indexing" and \
            ctx.extra.get("visual_index") is None:
        return 0
    from eioku_tpu_torch.workers.task_handler import _enqueue_followup
    n = 0
    for video_id in sorted(asset_ids):
        video = ctx.videos.get(video_id)
        if video is None:
            continue
        _enqueue_followup(ctx, video_id, video.path, task_type)
        n += 1
    return n
