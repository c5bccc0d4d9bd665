"""ML worker service entrypoint of the PyTorch port.

Port of eioku_tpu/workers/main.py: queue `ml_jobs`, WORKER_MAX_JOBS default
1 to serialise the accelerator, job timeout 3600 s, max_tries 1, poll
0.1 s, schema registration at startup, a reconcile cron every 5 min. The
engine, the semantic and visual indexes and the reranker run on CUDA;
EIOKU_FORCE_CPU=1 puts them on the CPU instead (tests, hosts without a
card). Without that variable, a host without CUDA makes the worker raise at
start: it never carries on on the CPU. At start it joins a multi-host
process group when EIOKU_COORDINATOR (host:port), EIOKU_NUM_PROCESSES and
EIOKU_PROCESS_ID say so (parallel/mesh.py initialize_distributed: NCCL on
the card, gloo under EIOKU_FORCE_CPU=1; a no-op without a coordinator). As
in the JAX package, the worker only serves the queue: merging the configured scan paths
and discovering videos at start is the API's start-up work
(api/app.py create_app).

Usage: python -m eioku_tpu_torch.workers.main [--config PATH] [--db URL]
       [--max-jobs N] [--once]
"""
from __future__ import annotations

import argparse
import asyncio

from eioku_tpu_torch.api.app import build_context
from eioku_tpu_torch.config.settings import load_config
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.parallel.mesh import initialize_distributed
from eioku_tpu_torch.queue.queue import SqliteJobQueue
from eioku_tpu_torch.queue.worker import Worker, WorkerSettings
from eioku_tpu_torch.utils.device import entry_point_device
from eioku_tpu_torch.utils.logging import setup_logging
from eioku_tpu_torch.workers.task_handler import process_ml_task


def build_worker(app_ctx=None, config=None, settings: WorkerSettings | None = None,
                 engine: InferenceEngine | None = None,
                 reconcile_interval_s: float = 300.0) -> Worker:
    # None is CUDA: the engine raises on a host without a card
    device = entry_point_device(needs_card=False)
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
    initialize_distributed()  # multi-host no-op unless EIOKU_COORDINATOR is set
    config = load_config(args.config)
    if args.db:
        config.database_url = args.db
    settings = WorkerSettings()
    if args.max_jobs is not None:
        settings.max_jobs = args.max_jobs
    worker = build_worker(config=config, settings=settings)

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
