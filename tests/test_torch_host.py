"""The PyTorch port's worker/queue/DB host stack against the JAX package's
(CPU).

- The host modules the port copies are the JAX package's modules with the
  import prefix rewritten: their ASTs (docstrings aside) are equal, and the
  SPA's files are byte-equal. The few modules the port changes are listed
  with the names that differ and why.
- process_ml_task, fed the same scripted engine results, writes the same
  artifacts, runs, projections, FTS rows, task statuses and follow-up jobs
  through both packages, each on its own SQLite file.
- Discovery (create_app's start-up hook, as the API runs it) and a worker
  drain on a real clip give equal scene and metadata rows through both
  packages; the port's visual_analysis through the worker writes the rows
  its engine returns.
- Failures end the task FAILED with the error recorded; the worker runs on
  the CPU only when EIOKU_FORCE_CPU=1 asks for it; maybe_profile writes a
  torch.profiler trace.
"""
import ast
import asyncio
import json
import os
import pathlib
import re
import sys

import cv2
import numpy as np
import pytest
import torch

from eioku_tpu.api.app import build_context as jax_build_context
from eioku_tpu.api.app import create_app as jax_create_app
from eioku_tpu.config.settings import AppConfig as JaxAppConfig
from eioku_tpu.db.connection import Database as JaxDatabase
from eioku_tpu.domain.models import Task as JaxTask
from eioku_tpu.domain.models import Video as JaxVideo
from eioku_tpu.queue.worker import WorkerSettings as JaxWorkerSettings
from eioku_tpu.utils.hashing import hash_file as jax_hash_file
from eioku_tpu.workers.main import build_worker as jax_build_worker
from eioku_tpu.workers.task_handler import process_ml_task as jax_process_ml_task
from eioku_tpu_torch.api.app import build_context, create_app
from eioku_tpu_torch.config.settings import AppConfig, load_config
from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.models import Task, TaskStatus, Video
from eioku_tpu_torch.index.rerank import Reranker
from eioku_tpu_torch.index.semantic import SemanticIndex
from eioku_tpu_torch.index.visual import VisualIndex
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.queue.worker import WorkerSettings
from eioku_tpu_torch.utils.hashing import hash_file
from eioku_tpu_torch.utils.metrics import maybe_profile
from eioku_tpu_torch.workers import main as worker_main
from eioku_tpu_torch.workers.main import build_worker
from eioku_tpu_torch.workers.task_handler import process_ml_task
from test_torch_ocr import _write_text_clip as write_text_clip
from test_torch_ocr import single_torch_thread, use_small_detector, write_ocr_checkpoints

REPO = pathlib.Path(__file__).resolve().parent.parent

# Host modules the port copies unchanged apart from the import prefix.
COPIED = [
    "domain/__init__.py", "domain/artifacts.py", "domain/models.py",
    "domain/task_registry.py", "domain/schema_registry.py",
    "domain/schemas/__init__.py", "domain/schemas/payloads.py",
    "utils/hashing.py", "utils/logging.py",
    "db/__init__.py", "db/dialect.py", "db/connection.py", "db/migrations_defs.py",
    "db/migrations.py", "db/recovery.py", "db/pgwire.py",
    "config/__init__.py", "config/settings.py",
    "queue/__init__.py", "queue/jobs.py", "queue/queue.py", "queue/producer.py",
    "queue/worker.py",
    "repositories/__init__.py", "repositories/_util.py",
    "repositories/artifact_repository.py", "repositories/path_config_repository.py",
    "repositories/run_repository.py", "repositories/selection_policy_manager.py",
    "repositories/task_repository.py", "repositories/video_repository.py",
    "services/__init__.py", "services/geo_data.py", "services/geocoding.py",
    "services/projection_sync.py", "services/discovery.py", "services/reconciler.py",
    "services/find_service.py", "services/jump_service.py",
    "services/subtitles.py", "services/people.py", "services/clips.py",
    "services/dump.py", "services/import_eioku.py",
    "ml/metadata.py", "workers/__init__.py", "workers/task_handler.py",
    "models/embed/tokenizer.py", "models/embed/native_tokenizer.py",
    "models/clip/tokenizer.py", "models/whisper/align.py",
    "web/__init__.py", "web/framework.py", "web/server.py", "web/testing.py",
    "api/__init__.py", "api/controllers.py",
]

# Functions the port copies into a module of its own: (module, name).
COPIED_FUNCTIONS = [
    ("ml/audio_io.py", "_configure_av"), ("ml/audio_io.py", "native_encode"),
    ("ml/audio_io.py", "native_media_encode"),
]

# The SPA, served from the package's own frontend/ (api/controllers.py).
FRONTEND = ["index.html", "app.js", "style.css"]
# The one difference the copies may have: the JAX files' paths into the
# reference source drop their leading "/<dir>/reference/", as the Python
# copies' docstrings do.
REFERENCE_PREFIX = re.compile(rb"/\w+/reference/")

# Host modules the port changes: the top-level names that differ, and why.
# Every other top-level class, function and assignment must be equal.
CHANGED = {
    "utils/metrics.py": ({"maybe_profile", "merge_spans", "_events_close", "METRICS",
                          "TaskMetrics", "_Task", "_Span", "_OPEN_SPAN", "_KEPT_SPANS",
                          "_NO_SPAN", "RECENT_TASKS", "_SPAN_TRACK"},
                         "traces with torch.profiler, not jax.profiler, and appends the "
                         "program's spans to that trace; METRICS is a registry that also "
                         "keeps the spans and counters of the port's tasks"),
    "api/app.py": ({"build_context"},
                   "the semantic index, the reranker and the visual index "
                   "take a device"),
    "api/main.py": ({"main"},
                    "the port's device rule replaces maybe_force_cpu: "
                    "EIOKU_FORCE_CPU puts the indexes on the CPU, otherwise "
                    "CUDA, and a host without a card raises at start when "
                    "semantic or visual search is on"),
    "workers/main.py": ({"build_worker", "main"},
                        "EIOKU_FORCE_CPU picks the engine's and the indexes' "
                        "device and the process group's backend (the port's "
                        "initialize_distributed)"),
    "cli.py": ({"_ctx", "cmd_finetune"},
               "_ctx takes the API's device rule; cmd_finetune joins the process "
               "group first (the port's initialize_distributed), as the worker does, "
               "since the port's mesh spans the ranks of that group"),
}


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:]
    return tree


def _port_tree(path: pathlib.Path) -> ast.Module:
    return _strip_docstrings(ast.parse(path.read_text()))


def _jax_tree_rewritten(rel: str) -> ast.Module:
    src = (REPO / "eioku_tpu" / rel).read_text()
    src = src.replace("eioku_tpu.", "eioku_tpu_torch.").replace(
        "from eioku_tpu import", "from eioku_tpu_torch import")
    return _strip_docstrings(ast.parse(src))


def _top_level(tree: ast.Module) -> dict[str, str]:
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_the_jax_module(rel):
    assert ast.dump(_port_tree(REPO / "eioku_tpu_torch" / rel)) == \
        ast.dump(_jax_tree_rewritten(rel)), rel


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_module_differs_only_where_listed(rel):
    differs, reason = CHANGED[rel]
    assert reason
    port = _top_level(_port_tree(REPO / "eioku_tpu_torch" / rel))
    jax_side = _top_level(_jax_tree_rewritten(rel))
    for name, dump in jax_side.items():
        if name not in differs:
            assert port.get(name) == dump, (rel, name)
    for name in differs & port.keys() & jax_side.keys():
        assert port[name] != jax_side[name], (rel, name, "listed but equal")
    assert port.keys() - jax_side.keys() <= differs, (rel, "names of the port's own")


@pytest.mark.parametrize("rel,name", COPIED_FUNCTIONS)
def test_copied_function_equals_the_jax_function(rel, name):
    port = _top_level(_port_tree(REPO / "eioku_tpu_torch" / rel))
    assert port[name] == _top_level(_jax_tree_rewritten(rel))[name], (rel, name)


@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_file_equals_the_jax_file(name):
    assert (REPO / "eioku_tpu_torch" / "frontend" / name).read_bytes() == \
        REFERENCE_PREFIX.sub(b"", (REPO / "eioku_tpu" / "frontend" / name).read_bytes())


def test_every_host_module_is_listed():
    host_dirs = ("domain", "db", "config", "queue", "repositories", "services",
                 "api", "workers", "web")
    found = {str(p.relative_to(REPO / "eioku_tpu_torch"))
             for d in host_dirs for p in (REPO / "eioku_tpu_torch" / d).rglob("*.py")}
    found |= {"utils/hashing.py", "utils/logging.py", "utils/metrics.py",
              "ml/metadata.py", "models/embed/tokenizer.py",
              "models/embed/native_tokenizer.py", "models/clip/tokenizer.py",
              "models/whisper/align.py", "cli.py"}
    assert found == set(COPIED) | set(CHANGED)
    # every function of the JAX audio_io that the CLI or the clips service
    # calls, and the ctypes signatures they need, is in the port's copy
    jax_audio = _top_level(_jax_tree_rewritten("ml/audio_io.py"))
    port_audio = _top_level(_port_tree(REPO / "eioku_tpu_torch" / "ml/audio_io.py"))
    assert {"native_encode", "native_media_encode", "_configure_av"} == \
        {name for rel, name in COPIED_FUNCTIONS if rel == "ml/audio_io.py"}
    assert {"native_encode", "native_media_encode"} <= port_audio.keys() & jax_audio.keys()
    assert sorted(p.name for p in (REPO / "eioku_tpu_torch" / "frontend").iterdir()) == \
        sorted(FRONTEND) == sorted(p.name for p in (REPO / "eioku_tpu" / "frontend").iterdir())


# ---------------------------------------------------------------------------
# process_ml_task on a scripted engine, through both packages

_SCENES = [{"payload": {"scene_index": i, "start_ms": s, "end_ms": e,
                        "duration_ms": e - s, "score": 0.25},
            "span_start_ms": s, "span_end_ms": e}
           for i, (s, e) in enumerate([(0, 2000), (2000, 5000), (5000, 7000)])]
_OBJECTS = [{"payload": {"label": lab, "confidence": c, "frame_number": f,
                         "bounding_box": {"x": 1.0, "y": 2.0, "width": 10.0,
                                          "height": 12.5}},
             "span_start_ms": f * 100, "span_end_ms": f * 100}
            for lab, c, f in [("person", 0.91, 0), ("car", 0.55, 10),
                              ("person", 0.72, 40)]]
_FACES = [{"payload": {"cluster_id": cid, "confidence": c, "frame_number": f,
                       "bounding_box": {"x": 4.0, "y": 4.0, "width": 8.0,
                                        "height": 8.0},
                       "embedding": [0.6, 0.8, 0.0]},
           "span_start_ms": f * 100, "span_end_ms": f * 100}
          for cid, c, f in [("face_0", 0.8, 0), ("face_1", 0.65, 30),
                            ("face_0", 0.77, 60)]]
_PLACES = [{"payload": {"frame_number": f, "predictions": [
               {"label": "kitchen", "confidence": 0.6},
               {"label": "office", "confidence": 0.3}]},
            "span_start_ms": f * 100, "span_end_ms": f * 100} for f in (0, 10)]
_TRANSCRIPT = [{"payload": {"text": text, "language": "en", "start_ms": s,
                            "end_ms": e, "confidence": 0.9},
                "span_start_ms": s, "span_end_ms": e}
               for text, s, e in [("hello world from the harbour", 0, 2500),
                                  ("the lighthouse keeper waves", 2500, 6000)]]
_METADATA = [{"payload": {"duration_ms": 7000, "width": 64, "height": 64,
                          "fps": 10.0, "codec": "mp4v", "container": "mp4",
                          "create_date": "2024-05-01T12:00:00",
                          "gps": {"latitude": 48.8566, "longitude": 2.3522}},
              "span_start_ms": 0, "span_end_ms": 7000}]
SCRIPTED = {
    "scene_detection": _SCENES, "object_detection": _OBJECTS,
    "face_detection": _FACES, "place_classification": _PLACES,
    "transcription": _TRANSCRIPT, "metadata_extraction": _METADATA,
    "visual_analysis": {"scene_detection": _SCENES, "object_detection": _OBJECTS,
                        "face_detection": _FACES, "place_classification": _PLACES},
}
SCRIPTED_CONFIGS = {t: {"threshold": 0.5, "task": t} for t in SCRIPTED}


class ScriptedEngine:
    """Returns fixed results per task type, as an engine's run_task would."""

    def __init__(self, producer_name: str):
        self.producer_name = producer_name
        self.producer_version = "0.1.0"
        self.model_profile = "balanced"

    def run_task(self, task_type, video_path, config):
        torch.ones(8).add_(1)  # an op for the profiler to see
        return json.loads(json.dumps(SCRIPTED[task_type]))


class Package:
    """One package's host stack: its context builder, app, types and handler."""

    def __init__(self, name, build_context, create_app, config_cls, database_cls,
                 task_cls, video_cls, hash_file, process, build_worker, settings_cls,
                 producer):
        self.name = name
        self.build_context = build_context
        self.create_app = create_app
        self.config_cls = config_cls
        self.database_cls = database_cls
        self.task_cls = task_cls
        self.video_cls = video_cls
        self.hash_file = hash_file
        self.process = process
        self.build_worker = build_worker
        self.settings_cls = settings_cls
        self.producer = producer


JAX = Package("jax", jax_build_context, jax_create_app, JaxAppConfig, JaxDatabase,
              JaxTask, JaxVideo, jax_hash_file, jax_process_ml_task, jax_build_worker,
              JaxWorkerSettings, "eioku-tpu-engine")
PORT = Package("port", build_context, create_app, AppConfig, Database, Task, Video,
               hash_file, process_ml_task, build_worker, WorkerSettings,
               "eioku-tpu-torch-engine")


def _context(pkg: Package, tmp: pathlib.Path, **config):
    config.setdefault("scan_paths", [])
    cfg = pkg.config_cls(semantic_search=False, visual_search=False, **config)
    return pkg.build_context(cfg, db=pkg.database_cls(f"sqlite:///{tmp}/{pkg.name}.db"))


def _api_startup(pkg: Package, ctx) -> None:
    """create_app's start-up and shut-down hooks, as the API runs them: the
    configured scan paths merge into the database, and discovery enqueues
    when auto_discover is on. The worker does neither."""
    app = pkg.create_app(ctx=ctx, start_reconciler=False)

    async def lifespan():
        for hook in app.on_startup + app.on_shutdown:
            await hook()
    asyncio.run(lifespan())


def _drain(pkg: Package, ctx, engine=None) -> None:
    worker = pkg.build_worker(app_ctx=ctx, engine=engine, settings=pkg.settings_cls(
        max_jobs=1, poll_delay_s=0.01))
    asyncio.run(worker.drain())


def _rows(db, sql: str) -> list[tuple]:
    return [tuple(r) for r in db.query(sql)]


def _db_state(ctx, video_id: str) -> dict:
    db = ctx.db
    return {
        "artifacts": _rows(db, "SELECT asset_id, artifact_type, schema_version, "
                               "span_start_ms, span_end_ms, payload_json, "
                               "producer_version, model_profile, config_hash, "
                               "input_hash FROM artifacts ORDER BY rowid"),
        "artifact_runs": _rows(db, "SELECT a.artifact_type, r.task_type FROM "
                                   "artifacts a JOIN runs r ON r.run_id = a.run_id "
                                   "ORDER BY a.rowid"),
        "runs": _rows(db, "SELECT asset_id, task_type, producer_version, model_profile,"
                          " config_hash, input_hash, config_json FROM runs "
                          "ORDER BY task_type, config_hash"),
        "scene_ranges": _rows(db, "SELECT asset_id, scene_index, start_ms, end_ms "
                                  "FROM scene_ranges ORDER BY rowid"),
        "object_labels": _rows(db, "SELECT asset_id, label, confidence, start_ms, "
                                   "end_ms FROM object_labels ORDER BY rowid"),
        "face_clusters": _rows(db, "SELECT asset_id, cluster_id, confidence, "
                                   "start_ms, end_ms FROM face_clusters ORDER BY rowid"),
        "video_locations": _rows(db, "SELECT asset_id, latitude, longitude, country, "
                                     "state, city FROM video_locations"),
        "transcript_fts": _rows(db, "SELECT f.text, m.asset_id, m.start_ms, m.end_ms,"
                                    " m.language FROM transcript_fts f JOIN "
                                    "transcript_fts_meta m ON m.rowid = f.rowid "
                                    "ORDER BY m.start_ms"),
        "find": [{k: v for k, v in hit.items() if k != "artifact_id"}
                 for q in ("lighthouse", "world", "harbor")
                 for hit in ctx.find.find(video_id, q)],
        "jump": {k: v for k, v in (ctx.jump.jump(video_id, "scene", 2500) or {}).items()
                 if k not in ("artifact_id", "run_id")},
        "tasks": sorted((t.task_type, t.status.value, t.error)
                        for t in ctx.tasks.find(limit=100)),
        "jobs": sorted((j.function, j.args[1], j.args[2], json.dumps(j.args[4]),
                        j.status.value)
                       for j in ctx.producer.queue.list_jobs(limit=100)),
        "video": tuple(_rows(db, "SELECT id, duration_ms, file_created_at "
                                 "FROM videos")),
    }


def _scripted_run(pkg: Package, tmp: pathlib.Path) -> dict:
    video_path = tmp / "clip.mp4"
    video_path.write_bytes(b"scripted engine input")
    ctx = _context(pkg, tmp)
    ctx.videos.save(pkg.video_cls(id="video-1", path=str(video_path),
                                  file_hash=pkg.hash_file(str(video_path)),
                                  size_bytes=video_path.stat().st_size))
    engine = ScriptedEngine(pkg.producer)
    for i, task_type in enumerate(SCRIPTED):
        task = pkg.task_cls(id=f"task-{i}", video_id="video-1", task_type=task_type,
                            config=SCRIPTED_CONFIGS[task_type])
        ctx.tasks.save(task)
        asyncio.run(pkg.process({"app_ctx": ctx, "engine": engine}, task.id,
                                task_type, "video-1", str(video_path),
                                SCRIPTED_CONFIGS[task_type]))
    before_drain = _db_state(ctx, "video-1")
    _drain(pkg, ctx, engine=engine)  # the semantic_indexing follow-up
    producers = {r[0] for r in _rows(ctx.db, "SELECT DISTINCT producer FROM artifacts")}
    return {"before": before_drain, "after": _db_state(ctx, "video-1"),
            "producers": producers}


@pytest.fixture(scope="module")
def scripted_runs(tmp_path_factory):
    return {pkg.name: _scripted_run(pkg, tmp_path_factory.mktemp(f"scripted_{pkg.name}"))
            for pkg in (JAX, PORT)}


@pytest.mark.parametrize("part", [
    "artifacts", "artifact_runs", "runs", "scene_ranges", "object_labels",
    "face_clusters", "video_locations", "transcript_fts", "find", "jump", "tasks",
    "jobs", "video"])
def test_handler_parity_on_scripted_results(scripted_runs, part):
    jax_run, port_run = scripted_runs["jax"], scripted_runs["port"]
    assert port_run["before"][part] == jax_run["before"][part]
    assert port_run["after"][part] == jax_run["after"][part]


def test_scripted_rows_and_projections_are_complete(scripted_runs):
    before = scripted_runs["port"]["before"]
    # 7 tasks: 3 + 3 + 3 + 2 + 2 + 1 single-type rows, and 3 + 3 + 3 + 2 from
    # visual_analysis (one run per sub type)
    assert len(before["artifacts"]) == 14 + 11
    assert len(before["runs"]) == 6 + 4
    assert len(before["scene_ranges"]) == 6
    assert {r[1] for r in before["face_clusters"]} == {"face_0", "face_1"}
    assert before["video_locations"][0][3:] == ("France", "Ile-de-France", "Paris")
    assert before["video"] == (("video-1", 7000, "2024-05-01T12:00:00"),)
    assert before["jump"]["start_ms"] == 5000
    # "harbor" does not match "harbour" (porter stems differ, no substring)
    assert [h["jump_to"]["start_ms"] for h in before["find"]] == [2500, 0]
    assert scripted_runs["port"]["producers"] == {"eioku-tpu-torch-engine"}
    assert scripted_runs["jax"]["producers"] == {"eioku-tpu-engine"}
    # transcription enqueued semantic_indexing; with no index built it fails
    assert ("process_ml_task", "semantic_indexing", "video-1") in \
        {j[:3] for j in before["jobs"]}
    after = scripted_runs["port"]["after"]
    failed = [t for t in after["tasks"] if t[0] == "semantic_indexing"]
    assert failed == [("semantic_indexing", "failed",
                       "RuntimeError: semantic index not configured on this worker")]


# ---------------------------------------------------------------------------
# real engines: discovery and a worker drain on a clip

def _write_clip(path: str, segments, fps: int = 10, size=(64, 64)) -> None:
    """The 3-scene clip of tests/test_ml_pipeline.py: solid colours with a
    little noise, mp4v."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert w.isOpened()
    rng = np.random.default_rng(0)
    for n_frames, (r, g, b) in segments:
        base = np.zeros((size[1], size[0], 3), np.uint8)
        base[:, :] = (b, g, r)
        for _ in range(n_frames):
            noisy = base.astype(np.int16) + rng.integers(-4, 5, base.shape)
            w.write(np.clip(noisy, 0, 255).astype(np.uint8))
    w.release()


SCENE_SEGMENTS = [(20, (120, 0, 0)), (30, (30, 220, 30)), (20, (10, 10, 230))]


CLIP_MTIME = 1714564800  # metadata falls back to the file's mtime for create_date


def _clip_dir(tmp: pathlib.Path) -> pathlib.Path:
    clips = tmp / "videos"
    clips.mkdir()
    _write_clip(str(clips / "scenes.mp4"), SCENE_SEGMENTS)
    os.utime(clips / "scenes.mp4", (CLIP_MTIME, CLIP_MTIME))
    return clips


def _discover_and_drain(pkg: Package, tmp: pathlib.Path, engine=None, **config):
    clips = _clip_dir(tmp)
    ctx = _context(pkg, tmp, scan_paths=[str(clips)], **config)
    _api_startup(pkg, ctx)
    _drain(pkg, ctx, engine=engine)
    return ctx


def _artifact_rows(ctx) -> list[tuple]:
    return [(r[0], r[1], r[2], json.loads(r[3])) for r in ctx.db.query(
        "SELECT artifact_type, span_start_ms, span_end_ms, payload_json "
        "FROM artifacts ORDER BY artifact_type, rowid")]


@pytest.fixture(scope="module")
def e2e_runs(tmp_path_factory):
    config = {"active_task_types": ["scene_detection", "metadata_extraction"],
              "task_settings": {"scene_detection": {"decode_fast": 0}}}
    out = {}
    for pkg in (JAX, PORT):
        tmp = tmp_path_factory.mktemp(f"e2e_{pkg.name}")
        engine = InferenceEngine(device="cpu") if pkg is PORT else None
        out[pkg.name] = _discover_and_drain(pkg, tmp, engine=engine, **config)
    return out


def test_e2e_tasks_complete_through_both_packages(e2e_runs):
    for name, ctx in e2e_runs.items():
        tasks = ctx.tasks.find(limit=10)
        assert sorted(t.task_type for t in tasks) == ["metadata_extraction",
                                                      "scene_detection"], name
        assert {t.status.value for t in tasks} == {"completed"}, \
            [(t.task_type, t.error) for t in tasks]


@pytest.mark.parametrize("artifact_type", ["scene", "video.metadata"])
def test_e2e_rows_equal_the_jax_worker(e2e_runs, artifact_type):
    jax_rows = [r for r in _artifact_rows(e2e_runs["jax"]) if r[0] == artifact_type]
    port_rows = [r for r in _artifact_rows(e2e_runs["port"]) if r[0] == artifact_type]
    assert port_rows == jax_rows
    assert len(port_rows) == {"scene": 3, "video.metadata": 1}[artifact_type]


def test_e2e_projections_and_video_row(e2e_runs):
    for ctx in e2e_runs.values():
        video = ctx.videos.list()[0]
        assert video.duration_ms == 7000
        assert ctx.db.scalar("SELECT COUNT(*) FROM scene_ranges") == 3
        hit = ctx.jump.jump(video.id, "scene", 2500)
        assert abs(hit["start_ms"] - 5000) <= 300


VISUAL_SETTINGS = {
    "scene_detection": {"decode_fast": 0},
    "object_detection": {"batch_size": 8},
    "face_detection": {"batch_size": 8, "embeddings": True,
                       "confidence_threshold": 0.2},
    "place_classification": {"batch_size": 8},
}


class RecordingEngine(InferenceEngine):
    """The port's engine, keeping what each run_task returned."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.returned = []

    def run_task(self, task_type, video_path, config):
        out = super().run_task(task_type, video_path, config)
        self.returned.append((task_type, config, out))
        return out


def test_visual_analysis_through_the_worker_writes_the_engine_rows(tmp_path):
    engine = RecordingEngine(device="cpu")
    ctx = _discover_and_drain(
        PORT, tmp_path, engine=engine, combined_visual=True,
        active_task_types=["scene_detection", "object_detection", "face_detection",
                           "place_classification"],
        task_settings=VISUAL_SETTINGS)
    (task,) = ctx.tasks.find(limit=10)
    assert task.task_type == "visual_analysis" and task.status is TaskStatus.COMPLETED
    (task_type, config, returned), = engine.returned
    assert set(returned) == {"scene_detection", "object_detection", "face_detection",
                             "place_classification"}
    assert returned["face_detection"], "no face rows at threshold 0.2"
    # the worker's rows equal a direct run of the same engine on the same config
    direct = InferenceEngine(device="cpu").run_task(
        task_type, ctx.videos.list()[0].path, config)
    assert direct == returned
    kinds = {"scene_detection": "scene", "object_detection": "object.detection",
             "face_detection": "face.detection",
             "place_classification": "place.classification"}
    rows = _artifact_rows(ctx)
    for sub, artifact_type in kinds.items():
        got = [r[1:] for r in rows if r[0] == artifact_type]
        want = [(r["span_start_ms"], r["span_end_ms"], r["payload"]) for r in direct[sub]]
        assert got == want, sub
    clusters = {r[0] for r in _rows(ctx.db, "SELECT cluster_id FROM face_clusters")}
    assert clusters == {r["payload"]["cluster_id"] for r in direct["face_detection"]}
    assert ctx.db.scalar("SELECT COUNT(*) FROM object_labels") == \
        len(direct["object_detection"])


# ---------------------------------------------------------------------------
# failures through the port's queue

def _one_task(ctx):
    (task,) = ctx.tasks.find(limit=10)
    return task


def test_corrupted_file_fails(tmp_path):
    clips = tmp_path / "videos"
    clips.mkdir()
    (clips / "broken.mp4").write_bytes(b"not a video")
    ctx = _context(PORT, tmp_path, scan_paths=[str(clips)],
                   active_task_types=["scene_detection"])
    _api_startup(PORT, ctx)
    _drain(PORT, ctx, engine=InferenceEngine(device="cpu"))
    task = _one_task(ctx)
    assert task.status is TaskStatus.FAILED
    assert task.error


def test_changed_file_fails_with_hash_mismatch(tmp_path):
    clips = _clip_dir(tmp_path)
    ctx = _context(PORT, tmp_path, scan_paths=[str(clips)],
                   active_task_types=["scene_detection"])
    _api_startup(PORT, ctx)
    _write_clip(ctx.videos.list()[0].path, [(25, (9, 9, 9))])
    _drain(PORT, ctx, engine=InferenceEngine(device="cpu"))
    task = _one_task(ctx)
    assert task.status is TaskStatus.FAILED
    assert "changed since discovery" in task.error


@pytest.mark.parametrize("config,task_type", [
    ({"active_task_types": ["ocr"]}, "ocr"),
    # discovery folds an active ocr into visual_analysis
    ({"active_task_types": ["scene_detection", "ocr"], "combined_visual": True},
     "visual_analysis"),
])
def test_ocr_task_completes_through_the_queue(tmp_path, config, task_type, monkeypatch):
    """OCR, standalone or folded, runs from the queue: its rows land in
    ocr_fts and its semantic_indexing follow-up indexes them. The model
    cache holds tests/test_torch_ocr.py's checkpoints, which find text on
    its text clip at its small detector input."""
    use_small_detector(monkeypatch)
    clips = tmp_path / "videos"
    clips.mkdir()
    write_text_clip(str(clips / "text.mp4"))
    cache = tmp_path / "models"
    cache.mkdir()
    write_ocr_checkpoints(cache)
    cfg = AppConfig(scan_paths=[str(clips)], semantic_search=True, visual_search=False,
                    model_cache_dir=str(cache),
                    task_settings={"ocr": {"batch_size": 4, "decode_fast": 0},
                                   "scene_detection": {"decode_fast": 0}}, **config)
    ctx = build_context(cfg, db=Database(f"sqlite:///{tmp_path}/ocr.db"), device="cpu")
    _api_startup(PORT, ctx)
    engine = RecordingEngine(model_cache_dir=str(cache), device="cpu")
    with single_torch_thread():  # the CPU LSTM under the suite's load
        _drain(PORT, ctx, engine=engine)
    tasks = {t.task_type: t for t in ctx.tasks.find(limit=10)}
    assert set(tasks) == {task_type, "semantic_indexing"}
    assert all(t.status is TaskStatus.COMPLETED for t in tasks.values()), \
        [(t.task_type, t.error) for t in tasks.values()]
    (_, _, returned), = [r for r in engine.returned if r[0] == task_type]
    returned = {"ocr": returned} if task_type == "ocr" else returned
    rows = returned["ocr"]
    assert rows
    db_rows = _artifact_rows(ctx)
    for sub, artifact_type in (("ocr", "ocr.text"), ("scene_detection", "scene")):
        got = [r[1:] for r in db_rows if r[0] == artifact_type]
        assert got == [(r["span_start_ms"], r["span_end_ms"], r["payload"])
                       for r in returned.get(sub, [])], sub
    fts = _rows(ctx.db, "SELECT f.text, m.start_ms FROM ocr_fts f JOIN ocr_fts_meta m "
                        "ON m.rowid = f.rowid ORDER BY m.rowid")
    assert fts == [(r["payload"]["text"], r["span_start_ms"]) for r in rows]
    chunks = _rows(ctx.db, "SELECT source, start_ms FROM embedding_chunks ORDER BY slot")
    assert chunks and {c[0] for c in chunks} == {"ocr"}


def test_semantic_indexing_fails_not_configured(tmp_path):
    ctx = _context(PORT, tmp_path)
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"x")
    ctx.videos.save(Video(id="v", path=str(path)))
    task = Task(video_id="v", task_type="semantic_indexing", config={})
    ctx.tasks.save(task)
    ctx.producer.enqueue_task(task.id, "semantic_indexing", "v", str(path), {})
    _drain(PORT, ctx, engine=InferenceEngine(device="cpu"))
    task = ctx.tasks.get(task.id)
    assert task.status is TaskStatus.FAILED
    assert "not configured" in task.error


def test_build_context_warns_and_builds_no_index(tmp_path, caplog):
    # every index the config asks for is built, without a warning: the
    # semantic index, the reranker and the visual index (their device is
    # resolved only when a model is needed)
    cfg = AppConfig(scan_paths=[], semantic_search=True, visual_search=True)
    with caplog.at_level("WARNING", logger="eioku_tpu_torch.api.app"):
        ctx = build_context(cfg, db=Database(f"sqlite:///{tmp_path}/w.db"))
    assert isinstance(ctx.extra["semantic_index"], SemanticIndex)
    assert isinstance(ctx.extra["reranker"], Reranker)
    assert isinstance(ctx.extra["visual_index"], VisualIndex)
    assert ctx.extra["visual_index"].device is None
    assert not [r for r in caplog.records if r.name == "eioku_tpu_torch.api.app"]


def test_scene_result_enqueues_visual_indexing_which_completes(tmp_path):
    """A finished scene_detection enqueues visual_indexing; the port's worker
    runs it on its VisualIndex (full-width CLIP, random weights, on the CPU):
    one frame_embeddings row per scene midpoint, found by search."""
    cfg = AppConfig(scan_paths=[], semantic_search=False, visual_search=True,
                    model_cache_dir=str(tmp_path))
    ctx = build_context(cfg, db=Database(f"sqlite:///{tmp_path}/v.db"), device="cpu")
    path = tmp_path / "clip.mp4"
    _write_clip(str(path), SCENE_SEGMENTS)
    ctx.videos.save(Video(id="v", path=str(path), file_hash=hash_file(str(path))))
    ctx.tasks.save(Task(id="t", video_id="v", task_type="scene_detection", config={}))
    asyncio.run(process_ml_task({"app_ctx": ctx, "engine": ScriptedEngine("p")}, "t",
                                "scene_detection", "v", str(path), {}))
    jobs = [j.args[1] for j in ctx.producer.queue.list_jobs(limit=10)]
    assert "visual_indexing" in jobs
    worker = build_worker(app_ctx=ctx, engine=InferenceEngine(device="cpu"),
                          settings=WorkerSettings(max_jobs=1, poll_delay_s=0.01))
    assert worker.ctx["visual_index"] is ctx.extra["visual_index"]
    asyncio.run(worker.drain())
    tasks = {t.task_type: t for t in ctx.tasks.find(limit=10)}
    assert tasks["visual_indexing"].status is TaskStatus.COMPLETED, \
        tasks["visual_indexing"].error
    rows = _rows(ctx.db, "SELECT ts_ms, scene_index, model FROM frame_embeddings "
                         "ORDER BY slot")
    assert rows == [((s["span_start_ms"] + s["span_end_ms"]) // 2,
                     s["payload"]["scene_index"], "clip-vit-b32") for s in _SCENES]
    hits = ctx.extra["visual_index"].search("a green field", top_k=5)
    assert sorted(h["ts_ms"] for h in hits) == [r[0] for r in rows]
    assert all(h["video_id"] == "v" and h["source"] == "visual" for h in hits)


def test_semantic_indexing_completes_and_search_finds_the_video(tmp_path):
    # a finished transcription enqueues semantic_indexing; the port's worker
    # now runs it on its index, and the transcript becomes searchable
    cfg = AppConfig(scan_paths=[], semantic_search=True, visual_search=False,
                    model_cache_dir=str(tmp_path))
    ctx = build_context(cfg, db=Database(f"sqlite:///{tmp_path}/s.db"), device="cpu")
    index = ctx.extra["semantic_index"]
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"x")
    ctx.videos.save(Video(id="v", path=str(path), file_hash=hash_file(str(path))))
    ctx.tasks.save(Task(id="t", video_id="v", task_type="transcription", config={}))
    asyncio.run(process_ml_task({"app_ctx": ctx, "engine": ScriptedEngine("p")}, "t",
                                "transcription", "v", str(path), {}))
    _drain(PORT, ctx, engine=InferenceEngine(device="cpu"))
    tasks = {t.task_type: t for t in ctx.tasks.find(limit=10)}
    assert tasks["semantic_indexing"].status is TaskStatus.COMPLETED, \
        tasks["semantic_indexing"].error
    rows = _rows(ctx.db, "SELECT text, start_ms, end_ms FROM embedding_chunks")
    assert rows == [(" ".join(r["payload"]["text"] for r in _TRANSCRIPT), 0, 6000)]
    (hit,) = index.search("the lighthouse keeper waves", top_k=3)
    assert hit["video_id"] == "v" and hit["jump_to"] == {"start_ms": 0, "end_ms": 6000}
    assert ctx.db.scalar("SELECT COUNT(*) FROM topics WHERE asset_id = 'v'") > 0


# ---------------------------------------------------------------------------
# start-up and profiling

def test_worker_forced_onto_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("EIOKU_FORCE_CPU", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    worker = build_worker(app_ctx=_context(PORT, tmp_path))
    assert worker.ctx["engine"].device.type == "cpu"
    assert worker.ctx["engine"].producer_name == "eioku-tpu-torch-engine"


def test_worker_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("EIOKU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_worker(app_ctx=_context(PORT, tmp_path))


def test_worker_main_once_discovers_and_drains(tmp_path, monkeypatch):
    """As in the JAX package, the worker's main only drains: the videos of
    the config's paths are discovered by the API's start-up, and the next
    `--once` drains what it enqueued."""
    clips = _clip_dir(tmp_path)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "paths": [str(clips)], "database_url": f"sqlite:///{tmp_path}/main.db",
        "active_task_types": ["metadata_extraction"],
        "semantic_search": False, "visual_search": False}))
    monkeypatch.setenv("EIOKU_FORCE_CPU", "1")
    monkeypatch.setattr(worker_main, "setup_logging", lambda service: None)
    monkeypatch.setattr(sys, "argv", ["main", "--config", str(cfg), "--once"])
    worker_main.main()
    db = Database(f"sqlite:///{tmp_path}/main.db")
    assert db.scalar("SELECT COUNT(*) FROM videos") == 0  # the worker discovers nothing
    _api_startup(PORT, build_context(load_config(str(cfg)), device="cpu"))
    worker_main.main()
    assert _rows(db, "SELECT task_type, status FROM tasks") == \
        [("metadata_extraction", "completed")]
    assert db.scalar("SELECT duration_ms FROM videos") == 7000


def test_maybe_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("EIOKU_PROFILE_DIR", str(tmp_path / "prof"))
    with maybe_profile("scene_detection"):
        torch.ones(16).mul_(2)
    (trace,) = (tmp_path / "prof").glob("scene_detection-*/trace.json")
    assert "traceEvents" in json.loads(trace.read_text())


def test_handler_profiles_the_engine_call(tmp_path, monkeypatch):
    monkeypatch.setenv("EIOKU_PROFILE_DIR", str(tmp_path / "prof"))
    ctx = _context(PORT, tmp_path)
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"x")
    ctx.videos.save(Video(id="v", path=str(path), file_hash=hash_file(str(path))))
    asyncio.run(process_ml_task({"app_ctx": ctx, "engine": ScriptedEngine("p")},
                                "t", "scene_detection", "v", str(path), {}))
    assert ctx.tasks.get("t").status is TaskStatus.COMPLETED
    (trace,) = (tmp_path / "prof").glob("scene_detection-*/trace.json")
    # the engine's op ran in asyncio.to_thread's thread, not the profiler's
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::add_" in names
