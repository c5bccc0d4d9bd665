"""API application factory: AppContext, build_context and create_app.

Port of eioku_tpu/api/app.py. build_context registers the schemas, checks
and salvages a SQLite file, runs the migrations and wires the repositories,
the projection sync, discovery, find, jump and the reconciler, as the JAX
package's does. When config.semantic_search is on it puts the semantic
index (MiniLM, index/semantic.py) and the cross-encoder reranker
(index/rerank.py) into ctx.extra, and when config.visual_search is on the
visual index (CLIP, index/visual.py), all on `device` (None is CUDA,
resolved when a model or the corpus is first needed, so a context on a host
without a card works for everything else and its device work raises).

create_app is the JAX package's: it registers the /api/v1 routes
(api/controllers.py) on the port's web framework, and its startup merges
the configured scan paths into the database, discovers videos when
auto_discover is on, and starts the reconciliation loop and the optional
periodic discovery; shutdown stops them. CLI entry:
python -m eioku_tpu_torch.api.main [--config PATH] [--port N].
"""
from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any

from eioku_tpu_torch.config.settings import AppConfig, load_config
from eioku_tpu_torch.db.connection import Database, connect
from eioku_tpu_torch.db.migrations import run_migrations
from eioku_tpu_torch.domain.models import PathConfig
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
from eioku_tpu_torch.services.reconciler import Reconciler, reconciliation_loop
from eioku_tpu_torch.web.framework import App

log = logging.getLogger(__name__)


@dataclass
class AppContext:
    """All wired services; controllers receive this."""

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
        from eioku_tpu_torch.index.visual import VisualIndex
        ctx.extra["visual_index"] = VisualIndex(ctx, device=device)
    return ctx


def create_app(config: AppConfig | None = None, ctx: AppContext | None = None,
               auto_discover: bool | None = None,
               start_reconciler: bool = True) -> App:
    from eioku_tpu_torch.api import controllers

    ctx = ctx or build_context(config or load_config())
    app = App(title="eioku-tpu")
    app.state["ctx"] = ctx
    controllers.register_routes(app, ctx)

    stop = asyncio.Event()
    background: list[asyncio.Task] = []

    async def startup() -> None:
        # Merge configured scan paths into the DB (reference: config_loader.py:60-86).
        for p in ctx.config.scan_paths:
            if ctx.paths.get_by_path(p) is None:
                ctx.paths.save(PathConfig(
                    path=p,
                    recursive=ctx.config.path_recursive.get(
                        p, ctx.config.recursive)))
        do_discover = ctx.config.auto_discover if auto_discover is None else auto_discover
        if do_discover:
            report = ctx.discovery.discover()
            log.info("startup discovery", extra=report.to_dict())
        if start_reconciler:
            background.append(asyncio.create_task(reconciliation_loop(
                ctx.reconciler, ctx.config.reconcile_interval_s, stop)))
        # independent of auto_discover: skipping the startup scan must not
        # silently disable the periodic one (discover_interval_s is its own
        # opt-in knob, docs/DEPLOY.md)
        if ctx.config.discover_interval_s:
            from eioku_tpu_torch.services.discovery import discovery_loop
            background.append(asyncio.create_task(discovery_loop(
                ctx.discovery, ctx.config.discover_interval_s, stop)))

    async def shutdown() -> None:
        stop.set()
        for t in background:
            try:
                await asyncio.wait_for(t, timeout=5)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                t.cancel()

    app.on_startup.append(startup)
    app.on_shutdown.append(shutdown)
    return app
