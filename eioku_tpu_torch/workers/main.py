"""ML worker service entrypoint of the PyTorch port.

Port of eioku_tpu/workers/main.py: queue `ml_jobs`, WORKER_MAX_JOBS default
1 to serialise the accelerator, job timeout 3600 s, max_tries 1, poll
0.1 s, schema registration at startup, a reconcile cron every 5 min. The
engine, the semantic and visual indexes and the reranker run on CUDA;
EIOKU_FORCE_CPU=1 puts them on the CPU instead (tests, hosts without a card). Without that
variable, a host without CUDA makes the worker raise at start: it never
carries on on the CPU. Multi-host start-up
(the JAX package's initialize_distributed) is not ported.

Until the port has its API, the worker also does the API's start-up work
(eioku_tpu/api/app.py create_app's startup): it merges the configured scan
paths into the database and, when auto_discover is on, discovers videos and
enqueues their tasks before it serves the queue.

Usage: python -m eioku_tpu_torch.workers.main [--config PATH] [--db URL]
       [--max-jobs N] [--once]
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import os

from eioku_tpu_torch.api.app import build_context
from eioku_tpu_torch.config.settings import load_config
from eioku_tpu_torch.domain.models import PathConfig
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.queue.queue import SqliteJobQueue
from eioku_tpu_torch.queue.worker import Worker, WorkerSettings
from eioku_tpu_torch.utils.logging import setup_logging
from eioku_tpu_torch.workers.task_handler import process_ml_task

log = logging.getLogger(__name__)


def discover_at_start(app_ctx) -> dict | None:
    """Merge the configured scan paths into the database, then discover
    and enqueue when auto_discover is on; returns the discovery report."""
    cfg = app_ctx.config
    for p in cfg.scan_paths:
        if app_ctx.paths.get_by_path(p) is None:
            app_ctx.paths.save(PathConfig(
                path=p, recursive=cfg.path_recursive.get(p, cfg.recursive)))
    if not cfg.auto_discover:
        return None
    report = app_ctx.discovery.discover().to_dict()
    log.info("startup discovery", extra=report)
    return report


def build_worker(app_ctx=None, config=None, settings: WorkerSettings | None = None,
                 engine: InferenceEngine | None = None,
                 reconcile_interval_s: float = 300.0) -> Worker:
    # None is CUDA, which raises on a host without a card
    device = "cpu" if os.environ.get("EIOKU_FORCE_CPU") == "1" else None
    app_ctx = app_ctx or build_context(config or load_config(), device=device)
    engine = engine or InferenceEngine(
        model_cache_dir=app_ctx.config.model_cache_dir,
        model_profile=app_ctx.config.model_profile, device=device)
    queue = app_ctx.producer.queue
    if not isinstance(queue, SqliteJobQueue):
        queue = SqliteJobQueue(app_ctx.db)
    worker = Worker(queue, settings or WorkerSettings(),
                    ctx={"app_ctx": app_ctx, "engine": engine,
                         "semantic_index": app_ctx.extra.get("semantic_index"),
                         "visual_index": app_ctx.extra.get("visual_index")})
    worker.register("process_ml_task", process_ml_task)

    async def reconcile_cron(ctx):
        app_ctx.reconciler.run()

    worker.add_cron(reconcile_cron, interval_s=reconcile_interval_s)
    return worker


def main() -> None:
    parser = argparse.ArgumentParser(description="eioku PyTorch/CUDA ML worker")
    parser.add_argument("--config", default=None)
    parser.add_argument("--db", default=None)
    parser.add_argument("--max-jobs", type=int, default=None)
    parser.add_argument("--once", action="store_true",
                        help="drain the queue then exit")
    args = parser.parse_args()

    setup_logging("eioku-ml-worker")
    config = load_config(args.config)
    if args.db:
        config.database_url = args.db
    settings = WorkerSettings()
    if args.max_jobs is not None:
        settings.max_jobs = args.max_jobs
    worker = build_worker(config=config, settings=settings)
    discover_at_start(worker.ctx["app_ctx"])

    async def _serve() -> None:
        import signal

        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, worker.stop)
            except (NotImplementedError, RuntimeError):
                pass
        if args.once:
            await worker.drain()
        else:
            await worker.run()

    asyncio.run(_serve())


if __name__ == "__main__":
    main()
