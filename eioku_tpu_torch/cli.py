"""Ops CLI of the PyTorch port (port of eioku_tpu/cli.py).

Commands: `tasks` (tasks joined with their queue jobs), `videos`, `resync`
(rebuild projections; --semantic re-embeds the vector store), `reconcile`,
`search` (semantic search from the shell), `discover`, `export-clip`,
`people`, `import-eioku` (migrate a reference eioku database), `stats`,
`export-dump` / `import-dump` (library backup and restore) and
`extract-audio` and `finetune` (fine-tune the embedder on the indexed
transcripts over every card, MiniLM tensor-parallel over
--model-parallel of them: parallel/finetune.py; with EIOKU_COORDINATOR,
EIOKU_NUM_PROCESSES and EIOKU_PROCESS_ID set, one rank of a process
group, as the worker joins one).

The context's semantic and visual indexes and the fine-tune run on CUDA;
EIOKU_FORCE_CPU=1 puts them on the CPU instead. With semantic_search or
visual_search on (both are by default) and no card, every command raises at
start.

Usage: python -m eioku_tpu_torch.cli <command> [--db URL] [--config PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from eioku_tpu_torch.api.app import build_context
from eioku_tpu_torch.config.settings import load_config
from eioku_tpu_torch.utils.device import entry_point_device


def _ctx(args):
    config = load_config(getattr(args, "config", None))
    if args.db:
        config.database_url = args.db
    config.auto_discover = False
    device = entry_point_device(config.semantic_search or config.visual_search)
    return build_context(config, device=device)


def cmd_tasks(args) -> int:
    ctx = _ctx(args)
    tasks = ctx.tasks.find(limit=args.limit,
                           sort_by="created_at", descending=True)
    jobs = {j.job_id: j for j in ctx.producer.queue.list_jobs(limit=10000)}
    header = (f"{'TASK':36s} {'TYPE':22s} {'LANG':4s} {'STATUS':10s} "
              f"{'JOB':10s} {'RUNTIME':>8s}  ERROR")
    print(header)
    print("-" * len(header))
    for t in tasks:
        job = jobs.get(f"ml_{t.id}")
        job_status = job.status.value if job else "-"
        rt = f"{t.running_time_s:.1f}s" if t.running_time_s is not None else "-"
        print(f"{t.id:36s} {t.task_type:22s} {t.language or '-':4s} "
              f"{t.status.value:10s} {job_status:10s} {rt:>8s}  "
              f"{(t.error or '')[:60]}")
    counts = ctx.producer.queue.counts()
    print(f"\nqueue: {counts}")
    print(f"API: http://localhost:8080/api/v1/tasks")
    return 0


def cmd_videos(args) -> int:
    ctx = _ctx(args)
    for v in ctx.videos.list(limit=args.limit):
        dur = f"{v.duration_ms / 1000:.0f}s" if v.duration_ms else "-"
        print(f"{v.id:36s} {v.status.value:10s} {dur:>7s}  {v.path}")
    return 0


def cmd_resync(args) -> int:
    ctx = _ctx(args)
    n = ctx.projection_sync.resync_all()
    print(f"resynced {n} artifacts into projections")
    if getattr(args, "semantic", False):
        index = ctx.extra.get("semantic_index")
        if index is not None:
            print(f"rebuilt semantic index: {index.rebuild()} chunks")
    return 0


def cmd_export_clip(args) -> int:
    from eioku_tpu_torch.services.clips import export_clip
    src = args.video
    if not os.path.isfile(src):  # accept a library video id too
        ctx = _ctx(args)
        v = ctx.videos.get(src)
        if v is None:
            print(f"not a file or video id: {src}", file=sys.stderr)
            return 1
        src = v.path
    ok = export_clip(src, args.out, int(args.start_ms), int(args.end_ms))
    print(f"{'wrote' if ok else 'FAILED'} {args.out}")
    return 0 if ok else 1


def cmd_people(args) -> int:
    from eioku_tpu_torch.services.people import cluster_people
    ctx = _ctx(args)
    persons = cluster_people(ctx, threshold=args.threshold)
    for p in persons:
        print(f"{p['person_id']:12s} {p['total_faces']:5d} faces  "
              f"{p['video_count']:3d} videos")
        for o in p["occurrences"][:args.occurrences]:
            print(f"    {o['video_id'][:8]}  track={o['cluster_id']}"
                  f"  n={o['count']}  first={o['first_ms']}ms")
    if not persons:
        print("no face identities (run face_detection with"
              " {\"embeddings\": true})")
    return 0


def cmd_import_eioku(args) -> int:
    from eioku_tpu_torch.services.import_eioku import import_reference_db
    ctx = _ctx(args)
    counts = import_reference_db(ctx, args.source,
                                 rehash=not args.no_rehash)
    print(json.dumps(counts))
    return 0


def cmd_stats(args) -> int:
    """Library overview from the shell (same numbers as /api/v1/stats)."""
    ctx = _ctx(args)
    q = ctx.db.query
    videos = {r["status"]: r["n"] for r in q(
        "SELECT status, COUNT(*) AS n FROM videos GROUP BY status")}
    tasks = {r["status"]: r["n"] for r in q(
        "SELECT status, COUNT(*) AS n FROM tasks GROUP BY status")}
    arts = {r["artifact_type"]: r["n"] for r in q(
        "SELECT artifact_type, COUNT(*) AS n FROM artifacts"
        " GROUP BY artifact_type ORDER BY n DESC")}
    totals = q("SELECT COALESCE(SUM(duration_ms),0) AS dur,"
               " COALESCE(SUM(size_bytes),0) AS b FROM videos")[0]
    print(json.dumps({
        "videos": {"total": sum(videos.values()), "by_status": videos,
                   "duration_hours": round(totals["dur"] / 3.6e6, 2),
                   "size_gb": round(totals["b"] / 1e9, 2)},
        "tasks": {"total": sum(tasks.values()), "by_status": tasks},
        "artifacts": {"total": sum(arts.values()), "by_type": arts},
        "semantic_chunks": ctx.db.scalar(
            "SELECT COUNT(*) FROM embedding_chunks") or 0,
        "visual_keyframes": ctx.db.scalar(
            "SELECT COUNT(*) FROM frame_embeddings") or 0,
    }, indent=2))
    return 0


def cmd_export_dump(args) -> int:
    from eioku_tpu_torch.services.dump import export_dump
    ctx = _ctx(args)
    counts = export_dump(ctx, args.out,
                         include_embeddings=args.include_embeddings)
    print(json.dumps(dict(counts, out=args.out)), file=sys.stderr
          if args.out == "-" else sys.stdout)
    return 0


def cmd_import_dump(args) -> int:
    from eioku_tpu_torch.services.dump import import_dump
    ctx = _ctx(args)
    counts = import_dump(ctx, args.source, reindex=not args.no_reindex)
    print(json.dumps(counts))
    return 0


def cmd_reconcile(args) -> int:
    ctx = _ctx(args)
    report = ctx.reconciler.run()
    print(json.dumps(report.to_dict(), indent=2))
    return 0


def cmd_search(args) -> int:
    ctx = _ctx(args)
    index = ctx.extra.get("semantic_index")
    if index is None:
        print("semantic search disabled", file=sys.stderr)
        return 1
    for r in index.search(args.query, top_k=args.top_k):
        print(f"{r['score']:.3f}  {r['video_id'][:8]}  "
              f"[{r['jump_to']['start_ms']}ms]  {r['text'][:100]}")
    return 0


def cmd_discover(args) -> int:
    ctx = _ctx(args)
    report = ctx.discovery.discover()
    print(json.dumps(report.to_dict(), indent=2))
    return 0


def cmd_finetune(args) -> int:
    import torch.distributed as dist

    from eioku_tpu_torch.parallel.finetune import finetune_embedder
    from eioku_tpu_torch.parallel.mesh import initialize_distributed

    started = initialize_distributed()  # multi-host no-op unless EIOKU_COORDINATOR is set
    try:
        ctx = _ctx(args)
        stats = finetune_embedder(ctx, steps=args.steps, batch_size=args.batch_size,
                                  lr=args.lr, model_parallel=args.model_parallel,
                                  save_to=args.save_to)
    finally:
        if started:
            dist.destroy_process_group()
    print(json.dumps(stats, indent=2))
    return 0


def cmd_extract_audio(args) -> int:
    """Demux+decode a video's audio track (native libav shim) and write it
    back out — wav (PCM) or AAC in m4a/mp4/mov, by output extension."""
    from eioku_tpu_torch.ml import audio_io

    src = audio_io.find_audio_for_video(args.video)
    if src is None:
        print(json.dumps({"error": "no audio stream or sidecar found",
                          "video": args.video}))
        return 1
    audio = audio_io.load_audio(src)
    out = args.out
    if out.lower().endswith(".wav"):
        import wave

        import numpy as np
        with wave.open(out, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(audio_io.SAMPLE_RATE)
            w.writeframes((np.clip(audio, -1, 1) * 32767)
                          .astype(np.int16).tobytes())
    else:
        audio_io.native_encode(out, audio)
    print(json.dumps({"source": src, "out": out,
                      "seconds": round(len(audio) / audio_io.SAMPLE_RATE, 2)}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(prog="eioku", description="eioku-tpu ops CLI")
    parser.add_argument("--db", default=None, help="database URL")
    parser.add_argument("--config", default=None)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("tasks", help="task/queue status table")
    p.add_argument("--limit", type=int, default=50)
    p.set_defaults(fn=cmd_tasks)

    p = sub.add_parser("videos", help="video library listing")
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_videos)

    p = sub.add_parser("resync", help="rebuild all projections from artifacts")
    p.add_argument("--semantic", action="store_true",
                   help="also re-embed the semantic vector store")
    p.set_defaults(fn=cmd_resync)

    p = sub.add_parser("reconcile", help="run one reconciliation pass")
    p.set_defaults(fn=cmd_reconcile)

    p = sub.add_parser("search", help="semantic search from the shell")
    p.add_argument("query")
    p.add_argument("--top-k", type=int, default=10)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("discover", help="scan configured paths now")
    p.set_defaults(fn=cmd_discover)

    p = sub.add_parser("export-clip",
                       help="cut [start,end] of a video into a clip "
                            "(native stream-copy remux)")
    p.add_argument("video", help="file path or library video id")
    p.add_argument("out")
    p.add_argument("--start-ms", type=int, default=0)
    p.add_argument("--end-ms", type=int, required=True)
    p.set_defaults(fn=cmd_export_clip)

    p = sub.add_parser("people", help="cross-video face identities")
    p.add_argument("--threshold", type=float, default=0.45)
    p.add_argument("--occurrences", type=int, default=5)
    p.set_defaults(fn=cmd_people)

    p = sub.add_parser("import-eioku",
                       help="import a reference eioku SQLite database "
                            "(videos/artifacts/runs/selections; projections "
                            "are rebuilt, see docs/MIGRATION.md)")
    p.add_argument("--source", required=True, help="path to the eioku .db file")
    p.add_argument("--no-rehash", action="store_true",
                   help="keep source SHA-256 file hashes instead of "
                        "recomputing xxhash64 for files present on disk")
    p.set_defaults(fn=cmd_import_eioku)

    p = sub.add_parser("stats", help="library overview (counts, hours, bytes)")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("export-dump",
                       help="back up the library (videos/tasks/runs/"
                            "selections/artifacts) to one JSONL file "
                            "(.gz compresses; '-' streams to stdout)")
    p.add_argument("--out", required=True)
    p.add_argument("--include-embeddings", action="store_true",
                   help="also dump embedding.chunk artifacts (their index "
                        "slots only make sense on this installation)")
    p.set_defaults(fn=cmd_export_dump)

    p = sub.add_parser("import-dump",
                       help="restore an export-dump file (idempotent; "
                            "projections rebuilt, semantic index re-enqueued)")
    p.add_argument("--source", required=True, help="dump file or '-' (stdin)")
    p.add_argument("--no-reindex", action="store_true",
                   help="do not re-enqueue semantic_indexing for restored "
                        "transcripts")
    p.set_defaults(fn=cmd_import_dump)

    p = sub.add_parser("extract-audio",
                       help="decode a video's audio track to wav/m4a")
    p.add_argument("video")
    p.add_argument("out")
    p.set_defaults(fn=cmd_extract_audio)

    p = sub.add_parser("finetune",
                       help="fine-tune the embedder on indexed transcripts")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--save-to", default=None)
    p.set_defaults(fn=cmd_finetune)

    args = parser.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
