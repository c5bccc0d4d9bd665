"""The pipeline core: execute one ML task end-to-end.

Copy of eioku_tpu/workers/task_handler.py for the PyTorch port.

Capability parity: ml-service/src/workers/task_handler.py:22-594:
per job — mark task RUNNING -> dispatch to the engine by task_type -> wrap results
into ArtifactEnvelopes (fresh run_id per job; artifact_id =
"{video_id}_{task_type}_{run8}_{idx}"; span from result or point timestamp;
metadata = one artifact spanning the video) -> bulk insert with projection sync in
one transaction -> task COMPLETED. CancelledError -> CANCELLED; any exception ->
FAILED with the error recorded. metadata_extraction additionally updates the
video row (duration, file_created_at; reference task_handler.py:491-594).

New in this rebuild: a completed transcription enqueues a semantic_indexing task
whose handler embeds transcript chunks into the TPU retrieval index.
"""
from __future__ import annotations

import asyncio
import logging
import uuid
from datetime import datetime
from typing import Any

from eioku_tpu_torch.domain.artifacts import ArtifactEnvelope, Run, utcnow
from eioku_tpu_torch.domain.models import Task, TaskStatus
from eioku_tpu_torch.domain.task_registry import TASK_REGISTRY
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.hashing import compute_config_hash, compute_input_hash
from eioku_tpu_torch.utils.metrics import METRICS, maybe_profile

log = logging.getLogger(__name__)


def build_envelopes(results: list[dict], *, video_id: str, artifact_type: str,
                    run_id: str, producer: str, producer_version: str,
                    model_profile: str, config_hash: str, input_hash: str,
                    ) -> list[ArtifactEnvelope]:
    envs = []
    for idx, r in enumerate(results):
        envs.append(ArtifactEnvelope(
            artifact_id=f"{video_id}_{artifact_type}_{run_id[:8]}_{idx}",
            asset_id=video_id,
            artifact_type=artifact_type,
            schema_version=1,
            span_start_ms=int(r["span_start_ms"]),
            span_end_ms=int(r["span_end_ms"]),
            payload_json=r["payload"],
            producer=producer,
            producer_version=producer_version,
            model_profile=model_profile,
            config_hash=config_hash,
            input_hash=input_hash,
            run_id=run_id,
        ))
    return envs


async def process_ml_task(ctx: dict, task_id: str, task_type: str, video_id: str,
                          video_path: str, config: dict[str, Any]) -> dict:
    """Queue job entrypoint (registered as 'process_ml_task')."""
    app = ctx["app_ctx"]  # AppContext
    engine = ctx["engine"]
    task = app.tasks.get(task_id)
    if task is None:
        # Task row may not exist for ad-hoc jobs; synthesize one for bookkeeping.
        task = Task(id=task_id, video_id=video_id, task_type=task_type, config=config)
        app.tasks.save(task)
    if task.status in (TaskStatus.FAILED, TaskStatus.CANCELLED):
        # a requeued retry attempt arrives with the prior attempt's terminal
        # status; step through PENDING so the completion below stays legal
        app.tasks.update_status(task_id, TaskStatus.PENDING)
        task = app.tasks.get(task_id)
    if task.status is TaskStatus.PENDING:
        app.tasks.update_status(task_id, TaskStatus.RUNNING)
    try:
        # Pipelines narrate fractional completion via progress.report(); the
        # sink persists it onto the task row (throttled), where it reaches
        # /tasks and the /tasks/stream SSE feed. asyncio.to_thread copies the
        # context, so the ContextVar sink is visible inside the engine thread.
        sink = progress.throttled(lambda f: app.tasks.set_progress(task_id, f))
        if task_type in ("semantic_indexing", "visual_indexing"):
            runner = _run_semantic_indexing if task_type == "semantic_indexing" \
                else _run_visual_indexing
            with METRICS.timer("task_seconds", task_type=task_type), \
                    progress.reporting(sink):
                n = await asyncio.to_thread(runner, app, ctx, video_id, config)
            app.tasks.update_status(task_id, TaskStatus.COMPLETED)
            METRICS.inc("tasks_completed", task_type=task_type)
            return {"artifacts": n}
        # Guard against the file changing between discovery and processing
        # (reference: ml-service/src/utils/input_validation.py:17-70).
        video = app.videos.get(video_id)
        current = None  # full-file hash, reused as input_hash below (one read)
        if video is not None and video.file_hash:
            from eioku_tpu_torch.utils.hashing import hash_file
            try:
                current = hash_file(video_path)
            except OSError:
                current = None
            if current is not None and current != video.file_hash:
                raise RuntimeError(
                    f"input file changed since discovery (hash "
                    f"{current[:12]} != {video.file_hash[:12]}); re-run "
                    "discovery to refresh the video record")
        # provenance hash BEFORE machine-local injections (the keyframe
        # cache path must not make identical configs look different)
        config_hash = compute_config_hash(config or {})
        if task_type == "visual_analysis" \
                and app.extra.get("visual_index") is not None:
            # the combined pass persists 1 s-grid keyframes next to the
            # visual index so the cascaded visual_indexing task reads them
            # instead of seek-decoding the source again (index/visual.py
            # _from_cache; ~18 s of redundant 1080p decode saved per minute)
            config = {**config, "keyframe_cache_dir": app.extra[
                "visual_index"].keyframe_cache_dir(video_id)}
        with METRICS.timer("task_seconds", task_type=task_type), \
                maybe_profile(task_type), progress.reporting(sink):
            results = await asyncio.to_thread(engine.run_task, task_type,
                                              video_path, config)
        try:
            input_hash = current[:16] if current is not None \
                else compute_input_hash(video_path)
        except OSError:
            input_hash = "missing"
        # combined tasks return {sub_task_type: results}; emit one run per sub
        # type so the artifact/run/selection model is unchanged
        result_sets = results if isinstance(results, dict) else \
            {task_type: results}
        envs = []
        run_id = None
        for sub_type, sub_results in result_sets.items():
            artifact_type = TASK_REGISTRY[sub_type].artifact_types[0]
            run_id = str(uuid.uuid4())
            sub_envs = build_envelopes(
                sub_results, video_id=video_id, artifact_type=artifact_type,
                run_id=run_id, producer=engine.producer_name,
                producer_version=engine.producer_version,
                model_profile=engine.model_profile, config_hash=config_hash,
                input_hash=input_hash)
            app.runs.save(Run(
                run_id=run_id, asset_id=video_id, task_type=sub_type,
                producer=engine.producer_name,
                producer_version=engine.producer_version,
                model_profile=engine.model_profile, config_hash=config_hash,
                input_hash=input_hash, config_json=config or {}))
            app.artifacts.batch_create(sub_envs)
            envs.extend(sub_envs)
        if task_type == "metadata_extraction" and envs:
            _update_video_from_metadata(app, video_id, envs[0].payload_json)
        if task_type in ("transcription", "ocr") or "ocr" in result_sets:
            # both text sources feed the semantic index (OCR also arrives as a
            # visual_analysis sub-result); re-indexing replaces the video's
            # slots, so double-triggering is idempotent
            _enqueue_semantic_indexing(app, video_id, video_path)
        if (task_type == "scene_detection" or "scene_detection" in result_sets) \
                and app.extra.get("visual_index") is not None:
            # scenes define the keyframes the CLIP image tower embeds
            _enqueue_followup(app, video_id, video_path, "visual_indexing")
        app.tasks.update_status(task_id, TaskStatus.COMPLETED)
        METRICS.inc("tasks_completed", task_type=task_type)
        METRICS.inc("artifacts_created", len(envs), task_type=task_type)
        log.info("task completed", extra={"task_id": task_id, "task_type": task_type,
                                          "artifacts": len(envs), "run_id": run_id})
        return {"artifacts": len(envs), "run_id": run_id}
    except asyncio.CancelledError:
        t = app.tasks.get(task_id)
        if t is not None and t.status is TaskStatus.RUNNING:
            app.tasks.update_status(task_id, TaskStatus.CANCELLED)
        raise
    except Exception as e:
        METRICS.inc("tasks_failed", task_type=task_type)
        t = app.tasks.get(task_id)
        if t is not None and t.status is TaskStatus.RUNNING:
            app.tasks.update_status(task_id, TaskStatus.FAILED,
                                    error=f"{type(e).__name__}: {e}")
        log.exception("task failed", extra={"task_id": task_id,
                                            "task_type": task_type})
        raise


def _update_video_from_metadata(app, video_id: str, payload: dict) -> None:
    video = app.videos.get(video_id)
    if video is None:
        return
    if payload.get("duration_ms"):
        video.duration_ms = int(payload["duration_ms"])
    create = payload.get("create_date")
    if create:
        try:
            video.file_created_at = datetime.fromisoformat(create)
        except ValueError:
            pass
    video.processed_at = utcnow()
    app.videos.save(video)


def _enqueue_followup(app, video_id: str, video_path: str,
                      task_type: str) -> None:
    """Fan in: an upstream task finished -> schedule its derived-index task
    (transcription/ocr -> semantic_indexing; scenes -> visual_indexing)."""
    existing = app.tasks.find(video_id=video_id, task_type=task_type, limit=1)
    config = app.config.settings_for(task_type)
    if existing:
        task = existing[0]
        if task.status in (TaskStatus.FAILED, TaskStatus.CANCELLED,
                           TaskStatus.COMPLETED):
            app.tasks.update_status(task.id, TaskStatus.PENDING)
    else:
        task = Task(video_id=video_id, task_type=task_type, config=config,
                    priority=TASK_REGISTRY[task_type].default_priority)
        app.tasks.save(task)
    app.producer.enqueue_task(task.id, task_type, video_id, video_path,
                              config, priority=task.priority)


def _enqueue_semantic_indexing(app, video_id: str, video_path: str) -> None:
    _enqueue_followup(app, video_id, video_path, "semantic_indexing")


def _run_semantic_indexing(app, ctx: dict, video_id: str, config: dict) -> int:
    index = ctx.get("semantic_index") or app.extra.get("semantic_index")
    if index is None:
        raise RuntimeError("semantic index not configured on this worker")
    return index.index_video(video_id, config)


def _run_visual_indexing(app, ctx: dict, video_id: str, config: dict) -> int:
    index = ctx.get("visual_index") or app.extra.get("visual_index")
    if index is None:
        raise RuntimeError("visual index not configured on this worker")
    return index.index_video(video_id, config)
