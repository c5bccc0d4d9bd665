"""Service wiring for the port's worker: AppContext and build_context.

Port of eioku_tpu/api/app.py:40-110. build_context registers the schemas,
checks and salvages a SQLite file, runs the migrations and wires the
repositories, the projection sync, discovery, find, jump and the reconciler,
as the JAX package's does. When config.semantic_search is on it puts the
semantic index (MiniLM, index/semantic.py) and the cross-encoder reranker
(index/rerank.py) into ctx.extra, on `device` (None is CUDA, resolved when a
model is first needed, so a context on a host without a card works for
everything else and its indexing tasks raise). Two parts wait for later
slices:

- create_app and the HTTP controllers (the API is not ported yet), so this
  module imports neither web/ nor api/controllers;
- the visual (CLIP) index. When config.visual_search asks for it, a warning
  names it and none is built, so a visual_indexing task fails with the task
  handler's "not configured" error.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any

from eioku_tpu_torch.config.settings import AppConfig
from eioku_tpu_torch.db.connection import Database, connect
from eioku_tpu_torch.db.migrations import run_migrations
from eioku_tpu_torch.domain.schema_registry import register_all_schemas
from eioku_tpu_torch.queue.producer import JobProducer
from eioku_tpu_torch.queue.queue import SqliteJobQueue
from eioku_tpu_torch.repositories import (
    ArtifactRepository,
    PathConfigRepository,
    RunRepository,
    SelectionPolicyManager,
    TaskRepository,
    VideoRepository,
)
from eioku_tpu_torch.services.discovery import VideoDiscoveryService
from eioku_tpu_torch.services.find_service import FindWithinVideoService
from eioku_tpu_torch.services.jump_service import JumpNavigationService
from eioku_tpu_torch.services.projection_sync import ProjectionSyncService
from eioku_tpu_torch.services.reconciler import Reconciler

log = logging.getLogger(__name__)


@dataclass
class AppContext:
    """All wired services; the worker's task handler receives this."""

    config: AppConfig
    db: Database
    videos: VideoRepository
    tasks: TaskRepository
    artifacts: ArtifactRepository
    runs: RunRepository
    paths: PathConfigRepository
    policies: SelectionPolicyManager
    producer: JobProducer
    projection_sync: ProjectionSyncService
    discovery: VideoDiscoveryService
    find: FindWithinVideoService
    jump: JumpNavigationService
    reconciler: Reconciler
    extra: dict[str, Any] = field(default_factory=dict)


def build_context(config: AppConfig | None = None,
                  db: Database | None = None,
                  producer: JobProducer | None = None,
                  device: str | None = None) -> AppContext:
    config = config or AppConfig()
    register_all_schemas()
    recovered = False
    if db is None and config.database_url.startswith("sqlite"):
        # corruption check + salvage BEFORE opening; the report lands in the
        # JSON log
        from eioku_tpu_torch.db.connection import _parse_sqlite_url
        from eioku_tpu_torch.db.recovery import check_and_recover

        report = check_and_recover(_parse_sqlite_url(config.database_url))
        recovered = bool(report.get("recovered"))
    db = db or connect(config.database_url)
    run_migrations(db)
    sync = ProjectionSyncService(db)
    if recovered:
        # FTS shadow tables are not salvaged — rebuild every projection from
        # the recovered artifacts table
        n = sync.resync_all()
        log.warning("rebuilt projections after database recovery",
                    extra={"artifacts": n})
    artifacts = ArtifactRepository(db, projection_sync=sync.sync_artifact)
    videos = VideoRepository(db)
    tasks = TaskRepository(db)
    paths = PathConfigRepository(db)
    runs = RunRepository(db)
    policies = SelectionPolicyManager(db)
    producer = producer or JobProducer(SqliteJobQueue(db))
    discovery = VideoDiscoveryService(config, videos, tasks, paths, producer,
                                      artifacts=artifacts, projection_sync=sync)
    ctx = AppContext(
        config=config, db=db, videos=videos, tasks=tasks, artifacts=artifacts,
        runs=runs, paths=paths, policies=policies, producer=producer,
        projection_sync=sync, discovery=discovery,
        find=FindWithinVideoService(db),
        jump=JumpNavigationService(artifacts, policies),
        reconciler=Reconciler(tasks, videos, producer),
    )
    if config.semantic_search:
        from eioku_tpu_torch.index.rerank import Reranker
        from eioku_tpu_torch.index.semantic import SemanticIndex
        ctx.extra["semantic_index"] = SemanticIndex(ctx, device=device)
        ctx.extra["reranker"] = Reranker(config.model_cache_dir, device=device)
    if getattr(config, "visual_search", False):
        log.warning("not built, not ported yet: visual index (CLIP); its "
                    "indexing tasks fail as not configured")
    return ctx
