"""The PyTorch port's HTTP API against the JAX package's (CPU).

One `create_app` from each package serves a SQLite file seeded alike (fixed
video, artifact, run and task ids) through its own `web.testing.TestClient`,
with its startup hook run (scan-path merge and discovery of one clip). Every
request of one table goes to both apps in the same order; uuid4 draws are
seeded alike, so the ids the servers mint (upload, discovery, indexing runs)
are equal too. Each package runs in the same directory in turn (the JAX
app's directory is moved aside before the port's is built), so paths and
database URLs are equal.

Compared: status codes and content types, and bodies equal after removing
only these fields:
- timestamps (`TIME_FIELDS`), and the free space of the volume on /health
  (`DISK_NOW`), which moves between the two runs;
- `producer` (hazard i: the port's engine and semantic index sign their
  rows with names of their own);
- /device's values: its keys must match (the port's card branch is taken
  with a CUDA answer stubbed in, since the host has none).
Binary bodies are compared by bytes, except the clip, which is compared by
its decoded frame count, and app.js, whose copy drops the JAX file's path
prefix into the reference source. Search hits (five modes and /similar) are compared
with hazards k, l and q ruled out first: the JAX semantic index runs bf16
where the port's runs fp32 on the CPU, so scores agree within SCORE_TOL and
hits at ranks whose scores keep more than SCORE_TOL from their neighbours'
are equal; both packages run the tiny CLIP of tests/test_clip.py at fp32, so
visual hits must keep gaps above GAP and agree within VISUAL_TOL.

Also: the API's device rule. Without CUDA and without EIOKU_FORCE_CPU, the
port's `api.main.main()` raises at start when semantic or visual search is
on, and serves when both are off.
"""
import contextlib
import json
import os
import pathlib
import random
import shutil
import sys
import uuid

import cv2
import numpy as np
import pytest
import torch

from eioku_tpu.api.app import build_context as jax_build_context
from eioku_tpu.api.app import create_app as jax_create_app
from eioku_tpu.config.settings import AppConfig as JaxAppConfig
from eioku_tpu.db.connection import Database as JaxDatabase
from eioku_tpu.domain import artifacts as jax_artifacts
from eioku_tpu.domain import models as jax_models
from eioku_tpu.models.clip.tokenizer import FallbackClipTokenizer as JaxFallbackClipTokenizer
from eioku_tpu.services import clips as jax_clips
from eioku_tpu.utils.metrics import METRICS as JAX_METRICS
from eioku_tpu.web.testing import TestClient as JaxTestClient
from eioku_tpu_torch.api import main as api_main
from eioku_tpu_torch.api.app import build_context, create_app
from eioku_tpu_torch.config.settings import AppConfig
from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain import artifacts as port_artifacts
from eioku_tpu_torch.domain import models as port_models
from eioku_tpu_torch.models.clip.tokenizer import FallbackClipTokenizer
from eioku_tpu_torch.services import clips as port_clips
from eioku_tpu_torch.utils.metrics import METRICS
from eioku_tpu_torch.web.testing import TestClient
from test_clip import TINY
from test_torch_host import REFERENCE_PREFIX
from test_torch_semantic import TOPICS, _rerank_cache, _write_minilm
from test_torch_visual import PORT_TINY
from test_torch_visual import _write_clip as write_block_clip

TIME_FIELDS = {"created_at", "started_at", "completed_at", "processed_at", "updated_at",
               "running_time_s", "file_created_at", "newest"}
DISK_NOW = {"free_bytes", "free_gb", "free_pct"}
REMOVED = TIME_FIELDS | DISK_NOW | {"producer"}
SCORE_TOL = 2e-2  # JAX bf16 MiniLM against the port's fp32 (hazard k)
RERANK_TOL = 5e-2  # rerank logits, bf16 against fp32
VISUAL_TOL = 1e-5  # tiny CLIP at fp32 in both packages
GAP = 1e-4  # visual hits are ranked where neighbours differ by more (hazard q)
UUID_SEED = 10


# ---------------------------------------------------------------------------
# one library, seeded alike through either package


class Package:
    def __init__(self, name, build_context, create_app, config_cls, database_cls,
                 artifacts, models, clips, metrics, client_cls, clip_tokenizer):
        self.name, self.build_context, self.create_app = name, build_context, create_app
        self.config_cls, self.database_cls = config_cls, database_cls
        self.artifacts, self.models, self.clips = artifacts, models, clips
        self.metrics, self.client_cls, self.clip_tokenizer = metrics, client_cls, \
            clip_tokenizer


JAX = Package("jax", jax_build_context, jax_create_app, JaxAppConfig, JaxDatabase,
              jax_artifacts, jax_models, jax_clips, JAX_METRICS, JaxTestClient,
              JaxFallbackClipTokenizer)
PORT = Package("port", build_context, create_app, AppConfig, Database, port_artifacts,
               port_models, port_clips, METRICS, TestClient, FallbackClipTokenizer)

TRANSCRIPT = [" ".join(words[:6]) for words in TOPICS] + \
    [" ".join(words[4:]) for words in TOPICS]  # 8 segments over four topics
FACE_A = np.r_[1.0, 0.2, np.zeros(30)]
FACE_B = np.r_[0.0, 0.1, -1.0, np.zeros(29)]


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


@contextlib.contextmanager
def seeded_uuid4():
    """uuid.uuid4 drawn from a seeded generator when either package calls it:
    both call it in the same order, so the ids they mint are equal. Other
    callers (a library imported on first use) keep the real draws."""
    rng = random.Random(UUID_SEED)
    real = uuid.uuid4

    def seeded():
        if not sys._getframe(1).f_globals.get("__name__", "").startswith("eioku_tpu"):
            return real()
        return uuid.UUID(int=rng.getrandbits(128), version=4)
    uuid.uuid4 = seeded
    try:
        yield
    finally:
        uuid.uuid4 = real


def _write_inputs(inputs: pathlib.Path) -> None:
    """The clips both packages read (distinct colour blocks: no two keyframes
    tie, hazard q), the model cache: a seeded MiniLM with scaled token
    embeddings (hazard l), the seeded cross-encoder and its vocab.txt."""
    (inputs / "media").mkdir(parents=True)
    write_block_clip(str(inputs / "media" / "a.mp4"), 30, seed=0)
    write_block_clip(str(inputs / "media" / "b.mp4"), 40, seed=1)
    write_block_clip(str(inputs / "scanned.mp4"), 20, seed=2)
    write_block_clip(str(inputs / "upload.mp4"), 25, seed=3)
    cache = inputs / "models"
    (cache / "minilm-l6").mkdir(parents=True)
    _write_minilm(cache)
    _rerank_cache(cache)


def _envelope(pkg: Package, artifact_id: str, asset: str, kind: str, span, payload,
              run: str, profile: str = "balanced"):
    return pkg.artifacts.ArtifactEnvelope(
        artifact_id=artifact_id, asset_id=asset, artifact_type=kind, schema_version=1,
        span_start_ms=span[0], span_end_ms=span[1], payload_json=payload,
        producer=f"seed-{pkg.name}", producer_version="1", model_profile=profile,
        config_hash="c", input_hash="i", run_id=run)


def _seed(pkg: Package, ctx, inputs: pathlib.Path) -> None:
    Video, Task, TaskStatus = pkg.models.Video, pkg.models.Task, pkg.models.TaskStatus
    media = inputs / "media"
    for vid, name, ms in (("vid-a", "a.mp4", 3000), ("vid-b", "b.mp4", 4000)):
        path = str(media / name)
        ctx.videos.save(Video(id=vid, path=path, file_hash=f"hash-{vid}",
                              size_bytes=os.path.getsize(path), duration_ms=ms))
    ctx.videos.save(Video(id="vid-gone", path=str(media / "missing.mp4"),
                          file_hash="gone"))
    env = lambda *a, **k: _envelope(pkg, *a, **k)  # noqa: E731
    # an older transcript run of another profile, then the newest: "latest"
    rows = [env("tr-fast-0", "vid-a", "transcript.segment", (0, 900),
                {"text": "an older faster draft", "language": "en", "start_ms": 0,
                 "end_ms": 900}, "run-tr-fast", profile="fast")]
    for i, text in enumerate(TRANSCRIPT):
        span = (i * 3000, i * 3000 + 2500)  # one RRF bucket (5 s) for every other
        rows.append(env(f"tr-{i}", "vid-a", "transcript.segment", span,
                        {"text": text, "language": "en", "start_ms": span[0],
                         "end_ms": span[1], "confidence": 0.9}, "run-tr"))
    for i, (s, e) in enumerate([(0, 1000), (1000, 2200), (2200, 3000)]):
        rows.append(env(f"scene-{i}", "vid-a", "scene", (s, e),
                        {"scene_index": i, "start_ms": s, "end_ms": e,
                         "duration_ms": e - s, "score": 0.3}, "run-scene"))
    for i, (label, conf, t) in enumerate([("person", 0.91, 100), ("dog", 0.55, 700),
                                          ("person", 0.72, 1900)]):
        rows.append(env(f"obj-{i}", "vid-a", "object.detection", (t, t),
                        {"label": label, "confidence": conf, "frame_number": t // 100,
                         "bounding_box": {"x": 1.0, "y": 2.0, "width": 10.0,
                                          "height": 12.0}}, "run-obj"))
    rng = np.random.default_rng(0)
    for i, (vid, cid, base, t) in enumerate([
            ("vid-a", "face_0", FACE_A, 200), ("vid-a", "face_0", FACE_A, 600),
            ("vid-a", "face_1", FACE_B, 1500), ("vid-b", "face_0", FACE_A, 300),
            ("vid-b", "face_0", FACE_A, 900)]):
        emb = _unit(base + rng.normal(0, 0.02, base.shape))
        rows.append(env(f"face-{i}", vid, "face.detection", (t, t),
                        {"cluster_id": cid, "confidence": 0.8, "frame_number": t // 100,
                         "bounding_box": {"x": 4.0, "y": 4.0, "width": 8.0,
                                          "height": 8.0},
                         "embedding": [float(x) for x in emb]}, f"run-face-{vid}"))
    rows.append(env("ocr-0", "vid-a", "ocr.text", (1000, 1000),
                    {"text": "HARBOUR CAFE open", "confidence": 0.8, "frame_index": 10,
                     "languages": ["en"], "polygon": [[0, 0], [10, 0], [10, 5], [0, 5]]},
                    "run-ocr"))
    for i, (label, s, e) in enumerate([("SPEAKER_0", 0, 10000), ("SPEAKER_1", 10000, 24000)]):
        rows.append(env(f"turn-{i}", "vid-a", "speaker.turn", (s, e),
                        {"label": label, "start_ms": s, "end_ms": e, "confidence": 1.0},
                        "run-dz"))
    rows.append(env("place-0", "vid-a", "place.classification", (0, 0),
                    {"frame_number": 0, "predictions": [
                        {"label": "harbor", "confidence": 0.6},
                        {"label": "boathouse", "confidence": 0.3}]}, "run-place"))
    rows.append(env("meta-b", "vid-b", "video.metadata", (0, 4000),
                    {"duration_ms": 4000, "width": 64, "height": 64, "fps": 10.0,
                     "codec": "mp4v", "container": "mp4",
                     "gps": {"latitude": 48.8566, "longitude": 2.3522}}, "run-meta"))
    ctx.artifacts.batch_create(rows)
    ctx.policies.set_policy("vid-a", "scene",
                            pkg.artifacts.SelectionPolicy(mode="pinned", run_id="run-scene"))
    for task_id, vid, task_type, status in (
            ("task-pending", "vid-a", "ocr", None),
            ("task-failed", "vid-a", "transcription", "failed"),
            ("task-done", "vid-b", "scene_detection", "completed"),
            ("task-cancel", "vid-b", "object_detection", None)):
        task = Task(id=task_id, video_id=vid, task_type=task_type)
        if status:
            task.transition(TaskStatus.RUNNING)
            task.transition(TaskStatus(status))
            task.error = "boom" if status == "failed" else None
        ctx.tasks.save(task)
    # the indexes: semantic chunks of vid-a's transcript, keyframes of a and b
    semantic = ctx.extra["semantic_index"]
    semantic.batch_size = 8  # a small padded batch keeps CPU queries cheap
    semantic.index_video("vid-a", {"chunk_chars": 60, "overlap_chars": 0})
    visual = ctx.extra["visual_index"]
    for vid in ("vid-a", "vid-b"):
        visual.index_video(vid, {"keyframe_interval_s": 1.0})


def _tiny_clip(pkg: Package, index, params, port_model) -> None:
    """The tiny CLIP of tests/test_clip.py in both packages' visual index
    (as tests/test_torch_visual.py injects it)."""
    if pkg is JAX:
        index._params, index._cfg = params, TINY
    else:
        index._model, index._cfg, index._dev = port_model, PORT_TINY, torch.device("cpu")
    index._tokenizer = pkg.clip_tokenizer(TINY.vocab_size)


# ---------------------------------------------------------------------------
# the request table: (name, method, url, request kwargs); run in this order

UPLOAD = "/api/v1/videos/upload?filename=second.mp4"
REQUESTS = [
    ("root", "GET", "/", {}),
    ("static_js", "GET", "/static/app.js", {}),
    ("static_css", "GET", "/static/style.css", {}),
    ("static_escape", "GET", "/static/../api/app.py", {}),
    ("api_root", "GET", "/api/v1", {}),
    ("routes", "GET", "/api/v1/routes", {}),
    ("openapi", "GET", "/openapi.json", {}),
    ("docs", "GET", "/docs", {}),
    ("health", "GET", "/health", {}),
    ("device", "GET", "/api/v1/device", {}),
    ("metrics", "GET", "/api/v1/metrics", {}),
    ("metrics_prometheus", "GET", "/api/v1/metrics?format=prometheus", {}),
    ("stats", "GET", "/api/v1/stats", {}),
    ("videos", "GET", "/api/v1/videos?sort_by=path&order=asc", {}),
    ("videos_filtered", "GET", "/api/v1/videos?q=a.mp4&limit=5", {}),
    ("videos_bad_status", "GET", "/api/v1/videos?status=nope", {}),
    ("video", "GET", "/api/v1/videos/vid-a", {}),
    ("video_missing", "GET", "/api/v1/videos/nope", {}),
    ("video_create", "POST", "/api/v1/videos", {"json": {"path": "/library/new.mp4",
                                                         "file_hash": "n"}}),
    ("video_create_dup", "POST", "/api/v1/videos", {"json": {"path": "/library/new.mp4"}}),
    ("video_patch", "PATCH", "/api/v1/videos/vid-b", {"json": {"status": "completed"}}),
    ("video_stream_range", "GET", "/api/v1/videos/vid-a/stream",
     {"headers": {"range": "bytes=100-1099"}}),
    ("video_stream", "GET", "/api/v1/videos/vid-b/stream", {}),
    ("thumbnail", "GET", "/api/v1/videos/vid-a/thumbnail", {}),
    ("thumbnail_cached", "GET", "/api/v1/videos/vid-a/thumbnail", {}),
    ("thumbnail_at", "GET", "/api/v1/videos/vid-a/thumbnail?at_ms=1500", {}),
    ("location", "GET", "/api/v1/videos/vid-b/location", {}),
    ("location_none", "GET", "/api/v1/videos/vid-a/location", {}),
    ("video_tasks", "GET", "/api/v1/videos/vid-a/tasks", {}),
    ("artifacts_transcript", "GET", "/api/v1/videos/vid-a/artifacts?type=transcript.segment",
     {}),
    ("artifacts_profile", "GET",
     "/api/v1/videos/vid-a/artifacts?type=transcript.segment&profile=fast", {}),
    ("artifacts_pinned", "GET",
     "/api/v1/videos/vid-a/artifacts?type=transcript.segment&run_id=run-tr", {}),
    ("artifacts_speakers", "GET", "/api/v1/videos/vid-a/artifacts?"
     "type=transcript.segment&with_speakers=1", {}),
    ("artifacts_objects", "GET",
     "/api/v1/videos/vid-a/artifacts?type=object.detection&label=person", {}),
    ("artifacts_window", "GET",
     "/api/v1/videos/vid-a/artifacts?type=scene&start_ms=900&end_ms=2000", {}),
    ("artifacts_bad_selection", "GET",
     "/api/v1/videos/vid-a/artifacts?type=scene&selection=bogus", {}),
    ("artifacts_faces_ocr_places", "GET", "/api/v1/videos/vid-b/artifacts", {}),
    ("artifacts_ocr", "GET", "/api/v1/videos/vid-a/artifacts?type=ocr.text", {}),
    ("artifacts_places", "GET",
     "/api/v1/videos/vid-a/artifacts?type=place.classification", {}),
    ("artifact_types", "GET", "/api/v1/videos/vid-a/artifact_types", {}),
    ("profiles", "GET", "/api/v1/videos/vid-a/profiles?artifact_type=transcript.segment",
     {}),
    ("runs", "GET", "/api/v1/videos/vid-a/runs?artifact_type=transcript.segment", {}),
    ("selection_get", "GET", "/api/v1/videos/vid-a/selection/scene", {}),
    ("selection_put", "PUT", "/api/v1/videos/vid-a/selection/transcript.segment",
     {"json": {"mode": "profile", "model_profile": "fast"}}),
    ("artifacts_stored_policy", "GET",
     "/api/v1/videos/vid-a/artifacts?type=transcript.segment", {}),
    ("selection_delete", "DELETE", "/api/v1/videos/vid-a/selection/transcript.segment", {}),
    ("jump_scene", "GET", "/api/v1/videos/vid-a/jump?kind=scene&from_ms=500", {}),
    ("jump_object", "GET",
     "/api/v1/videos/vid-a/jump?kind=object&label=person&from_ms=200", {}),
    ("jump_face_prev", "GET",
     "/api/v1/videos/vid-a/jump?kind=face&from_ms=2000&direction=prev", {}),
    ("jump_transcript", "GET", "/api/v1/videos/vid-a/jump?kind=transcript&from_ms=0", {}),
    ("jump_none", "GET", "/api/v1/videos/vid-a/jump?kind=scene&from_ms=9000", {}),
    ("jump_no_kind", "GET", "/api/v1/videos/vid-a/jump", {}),
    ("jump_options", "GET", "/api/v1/videos/vid-a/jump-options", {}),
    ("find_transcript", "GET", "/api/v1/videos/vid-a/find?q=harbour", {}),
    ("find_ocr", "GET", "/api/v1/videos/vid-a/find?q=cafe", {}),
    ("find_prev", "GET", "/api/v1/videos/vid-a/find?q=oven&from_ms=30000&direction=prev",
     {}),
    ("find_nothing", "GET", "/api/v1/videos/vid-a/find?q=zeppelin", {}),
    ("people", "GET", "/api/v1/people", {}),
    ("people_tight", "GET", "/api/v1/people?threshold=0.0001", {}),
    ("people_bad", "GET", "/api/v1/people?threshold=x", {}),
    ("clip", "GET", "/api/v1/videos/vid-a/clip?start_ms=500&end_ms=2000", {}),
    ("clip_bad_span", "GET", "/api/v1/videos/vid-a/clip?start_ms=900&end_ms=100", {}),
    ("clip_missing_file", "GET", "/api/v1/videos/vid-gone/clip?end_ms=1000", {}),
    ("subtitles_vtt", "GET", "/api/v1/videos/vid-a/subtitles?format=vtt", {}),
    ("subtitles_srt", "GET", "/api/v1/videos/vid-a/subtitles?format=srt", {}),
    ("subtitles_speakers", "GET", "/api/v1/videos/vid-a/subtitles?with_speakers=1", {}),
    ("subtitles_bad", "GET", "/api/v1/videos/vid-a/subtitles?format=ass", {}),
    ("topics", "GET", "/api/v1/videos/vid-a/topics", {}),
    ("paths", "GET", "/api/v1/paths", {}),
    ("paths_add", "POST", "/api/v1/paths", {"json": {"path": "/library/extra",
                                                     "recursive": False}}),
    ("paths_delete", "DELETE", "/api/v1/paths?path=/library/extra", {}),
    ("paths_delete_missing", "DELETE", "/api/v1/paths?path=/library/extra", {}),
    ("paths_validate", "POST", "/api/v1/paths/validate", {}),
    ("tasks", "GET", "/api/v1/tasks?sort_by=task_type&ascending=1", {}),
    ("tasks_failed", "GET", "/api/v1/tasks?status=failed", {}),
    ("task", "GET", "/api/v1/tasks/task-pending", {}),
    ("task_missing", "GET", "/api/v1/tasks/nope", {}),
    ("tasks_stream", "GET", "/api/v1/tasks/stream?max_events=1&interval=0.2", {}),
    ("task_enqueue", "POST", "/api/v1/tasks/task-pending/enqueue", {}),
    ("task_enqueue_done", "POST", "/api/v1/tasks/task-done/enqueue", {}),
    ("task_cancel", "POST", "/api/v1/tasks/task-cancel/cancel", {}),
    ("task_retry", "POST", "/api/v1/tasks/task-failed/retry", {}),
    ("task_retry_pending", "POST", "/api/v1/tasks/task-pending/retry", {}),
    ("tasks_reconcile", "POST", "/api/v1/tasks/reconcile", {}),
    ("search_semantic", "GET", "/api/v1/search?q=harbour boat anchor&top_k=4", {}),
    ("search_keyword", "GET", "/api/v1/search?q=oven&mode=keyword", {}),
    ("search_semantic_oven", "GET", "/api/v1/search?q=oven&top_k=4", {}),
    ("search_hybrid", "GET", "/api/v1/search?q=oven&mode=hybrid&top_k=4", {}),
    ("search_visual", "GET", "/api/v1/search?q=a red car&mode=visual&top_k=5", {}),
    ("search_visual_filtered", "GET",
     "/api/v1/search?q=night&mode=visual&top_k=3&video_id=vid-b", {}),
    ("search_rerank", "GET",
     "/api/v1/search?q=kitchen oven pasta&rerank=1&top_k=3", {}),
    ("search_no_query", "GET", "/api/v1/search", {}),
    ("search_bad_mode", "GET", "/api/v1/search?q=x&mode=psychic", {}),
    ("search_nothing", "GET", "/api/v1/search?q=zeppelin&mode=keyword", {}),
    ("similar", "GET", "/api/v1/videos/vid-a/similar?at_ms=1400&top_k=5", {}),
    ("upload", "PUT", UPLOAD, {"content": "upload.mp4"}),
    ("upload_dup", "PUT", UPLOAD, {"content": "upload.mp4"}),
    ("upload_bad_name", "PUT", "/api/v1/videos/upload?filename=../x.mp4",
     {"content": "upload.mp4"}),
    ("upload_bad_ext", "PUT", "/api/v1/videos/upload?filename=x.txt",
     {"content": "upload.mp4"}),
    ("videos_after_upload", "GET", "/api/v1/videos?sort_by=path&order=asc", {}),
    ("tasks_after_upload", "GET", "/api/v1/tasks?sort_by=task_type&ascending=1", {}),
    ("discover", "POST", "/api/v1/paths/discover", {}),
    ("video_delete", "DELETE", "/api/v1/videos/vid-b", {}),
    ("stats_after", "GET", "/api/v1/stats", {}),
    ("people_after_delete", "GET", "/api/v1/people", {}),
]
SEARCHES = {"search_semantic", "search_semantic_oven", "search_hybrid", "search_visual",
            "search_visual_filtered", "search_rerank", "similar"}
# the fused ranks follow the semantic ranks: its query's semantic hits must
# keep more than SCORE_TOL apart (hazard k) before the fusions are compared
HYBRID_SEMANTIC = {"search_hybrid": "search_semantic_oven"}


def _run(pkg: Package, root: pathlib.Path, inputs: pathlib.Path, params, port_model,
         monkeypatch) -> dict:
    """Build and seed `pkg`'s app in `root`, run its startup, send every
    request of the table; returns name -> (status, content type, body)."""
    library = root / "library"
    library.mkdir(parents=True)
    shutil.copy(inputs / "scanned.mp4", library / "scanned.mp4")
    monkeypatch.setattr(pkg.clips, "_CACHE_DIR", str(root / "clips"))
    pkg.metrics.reset()
    config = pkg.config_cls(
        scan_paths=[str(library)], auto_discover=True, model_cache_dir=str(inputs / "models"),
        active_task_types=["scene_detection", "transcription"])
    kw = {"device": "cpu"} if pkg is PORT else {}
    out = {}
    with seeded_uuid4():
        ctx = pkg.build_context(config, db=pkg.database_cls(f"sqlite:///{root}/eioku.db"),
                                **kw)
        _tiny_clip(pkg, ctx.extra["visual_index"], params, port_model)
        _seed(pkg, ctx, inputs)
        app = pkg.create_app(ctx=ctx, start_reconciler=False)
        with pkg.client_cls(app) as client:
            for name, method, url, req in REQUESTS:
                req = dict(req)
                if "content" in req:
                    req["content"] = (inputs / req["content"]).read_bytes()
                stub = _cuda_stub(monkeypatch) if name == "device" and pkg is PORT \
                    else contextlib.nullcontext()
                with stub:
                    r = client.request(method, url, **req)
                out[name] = (r.status_code, r.headers.get("content-type"), r.content)
    ctx.db.close()
    return out


@contextlib.contextmanager
def _cuda_stub(monkeypatch):
    """A host with one card, as torch.cuda would describe it."""
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        mp.setattr(torch.cuda, "get_device_name", lambda i=0: "stub card")
        yield


@pytest.fixture(scope="module")
def responses(tmp_path_factory):
    import jax

    from eioku_tpu.models.clip import model as jax_clip
    from eioku_tpu_torch.models.clip import model as port_clip
    from eioku_tpu_torch.models.layers import load_state

    params = jax_clip.init_clip_params(TINY, seed=0)
    port_model = load_state(port_clip.CLIP(PORT_TINY), port_clip.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))).eval()
    base = tmp_path_factory.mktemp("api")
    inputs = base / "inputs"
    _write_inputs(inputs)
    root = base / "root"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (JAX, PORT):
            with _cv2_clips(mp):
                out[pkg.name] = _run(pkg, root, inputs, params, port_model, mp)
            root.rename(base / f"root_{pkg.name}")
    return out


@contextlib.contextmanager
def _cv2_clips(mp):
    """Both packages' clip export on its cv2 re-encode path (the GPU host has
    no libavformat, so the native remux does not build there either)."""
    import eioku_tpu.ml.audio_io as jax_audio_io
    import eioku_tpu_torch.ml.audio_io as port_audio_io

    with mp.context() as m:
        m.setattr(jax_audio_io, "native_decoder", lambda: None)
        m.setattr(port_audio_io, "native_decoder", lambda: None)
        yield


# ---------------------------------------------------------------------------
# comparison


def _strip(value):
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if k not in REMOVED}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


def _frames(body: bytes, tmp: pathlib.Path) -> int:
    path = tmp / "clip.mp4"
    path.write_bytes(body)
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def _assert_hits_agree(got: list, want: list, tol: float, key: str) -> None:
    """Scores within `tol`; hits equal at every rank whose ordering score
    keeps more than `tol` from its neighbours' (hazard k)."""
    assert len(got) == len(want)
    order = [w[key] for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for score_key, score_tol in (("score", tol), ("rerank_score", RERANK_TOL)):
            if score_key in w:
                assert abs(g[score_key] - w[score_key]) <= score_tol, (i, g, w)
        neighbours = [order[j] for j in (i - 1, i + 1) if 0 <= j < len(order)]
        if all(abs(order[i] - s) > tol for s in neighbours):
            assert {k: v for k, v in g.items() if k not in ("score", "rerank_score")} == \
                {k: v for k, v in w.items() if k not in ("score", "rerank_score")}, i


def _assert_search_agrees(name: str, got: dict, want: dict, responses: dict) -> None:
    hits_key = "results"
    assert {k: v for k, v in got.items() if k != hits_key} == \
        {k: v for k, v in want.items() if k != hits_key}
    hits, want_hits = got[hits_key], want[hits_key]
    assert want_hits, name
    if name in ("search_visual", "search_visual_filtered", "similar"):
        scores = [h["score"] for h in want_hits]
        assert all(a - b > GAP for a, b in zip(scores, scores[1:])), scores  # hazard q
        _assert_hits_agree(hits, want_hits, VISUAL_TOL, "score")
    elif name == "search_rerank":
        assert got["reranked"] is True
        _assert_hits_agree(hits, want_hits, SCORE_TOL, "rerank_score")
    elif name in HYBRID_SEMANTIC:
        semantic = json.loads(responses["jax"][HYBRID_SEMANTIC[name]][2])["results"]
        scores = [h["score"] for h in semantic]
        assert all(a - b > SCORE_TOL for a, b in zip(scores, scores[1:])), scores
        assert hits == want_hits
    else:
        _assert_hits_agree(hits, want_hits, SCORE_TOL, "score")


@pytest.mark.parametrize("name", [r[0] for r in REQUESTS])
def test_route_answers_as_jax(responses, name, tmp_path):
    status, ctype, body = responses["port"][name]
    want_status, want_ctype, want_body = responses["jax"][name]
    assert (status, ctype) == (want_status, want_ctype), body[:300]
    if ctype and ctype.startswith("application/json"):
        got, want = _strip(json.loads(body)), _strip(json.loads(want_body))
        if name == "device":  # its keys; the values describe each host
            assert got.keys() == want.keys() and got["devices"] and want["devices"]
            assert got["devices"][0].keys() == want["devices"][0].keys()
            assert got["backend"] == "cuda" and got["devices"][0]["platform"] == "gpu"
        elif name in SEARCHES:
            _assert_search_agrees(name, got, want, responses)
        else:
            assert got == want
    elif ctype and ctype.startswith("text/event-stream"):
        data = lambda b: [_strip(json.loads(line[len("data: "):]))  # noqa: E731
                          for line in b.decode().splitlines() if line.startswith("data: ")]
        assert data(body) == data(want_body) and data(body)
    elif name == "clip":
        assert _frames(body, tmp_path) == _frames(want_body, tmp_path) > 0
    elif name == "static_js":  # the copy drops the JAX file's reference-source prefix
        assert body == REFERENCE_PREFIX.sub(b"", want_body) != want_body
    else:
        assert body == want_body


def test_the_table_reaches_every_route_group(responses):
    """Every route the JAX app registers, bar the SPA's static mount, is
    requested by the table, and the expected ones answer 200."""
    spec = json.loads(responses["jax"]["openapi"][2])
    requested = {url.split("?")[0] for _, _, url, _ in REQUESTS}
    templates = {p for p in spec["paths"] if "{" in p}
    import re
    hit = {p for p in spec["paths"] if p in requested} | {
        t for t in templates
        if any(re.fullmatch(re.sub(r"\{\w+\}", "[^/]+", t), u) for u in requested)}
    static = {p for p in spec["paths"] if p.startswith("/static")}  # the SPA's mount
    assert set(spec["paths"]) - hit - static == set()
    ok = {n for n, (status, _, _) in responses["port"].items() if 200 <= status < 300}
    for name in ("root", "health", "device", "metrics", "stats", "upload", "clip",
                 "subtitles_vtt", "tasks_stream", "people", "similar", "discover",
                 "video_stream_range") + tuple(sorted(SEARCHES)):
        assert name in ok, (name, responses["port"][name][:2])
    assert responses["port"]["video_stream_range"][0] == 206


def test_search_modes_reach_both_indexes(responses):
    """The port's answers come from its own indexes: semantic hits with
    cosine-like scores, the reranker's logits, CLIP keyframes."""
    body = lambda name: json.loads(responses["port"][name][2])  # noqa: E731
    semantic = body("search_semantic")["results"]
    assert semantic and all(h["video_id"] == "vid-a" for h in semantic)
    rerank = body("search_rerank")
    assert rerank["reranked"] is True and "rerank_score" in rerank["results"][0]
    visual = body("search_visual")["results"]
    assert {h["source"] for h in visual} == {"visual"}
    assert {h["video_id"] for h in body("search_visual_filtered")["results"]} == {"vid-b"}
    upload = body("upload")
    assert upload["tasks_created"] == 2 and upload["bytes"] > 0


# ---------------------------------------------------------------------------
# the API's device rule


def _api_config(tmp_path, **kw) -> str:
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"paths": [], "database_url": f"sqlite:///{tmp_path}/e.db",
                               "auto_discover": False, **kw}))
    return str(cfg)


@pytest.mark.parametrize("search", [{}, {"semantic_search": False},
                                    {"visual_search": False}])
def test_api_main_without_cuda_raises_at_start(tmp_path, monkeypatch, search):
    monkeypatch.delenv("EIOKU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(api_main, "setup_logging", lambda service: None)
    served = []
    monkeypatch.setattr(api_main, "run", lambda app, host, port: served.append(app))
    monkeypatch.setattr(sys, "argv", ["main", "--config", _api_config(tmp_path, **search)])
    with pytest.raises(RuntimeError, match="CUDA is not available.*EIOKU_FORCE_CPU"):
        api_main.main()
    assert not served


@pytest.mark.parametrize("env,search", [
    ("1", {}), (None, {"semantic_search": False, "visual_search": False})])
def test_api_main_serves_on_the_cpu_only_when_asked_or_without_search(
        tmp_path, monkeypatch, env, search):
    if env:
        monkeypatch.setenv("EIOKU_FORCE_CPU", env)
    else:
        monkeypatch.delenv("EIOKU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(api_main, "setup_logging", lambda service: None)
    served = []
    monkeypatch.setattr(api_main, "run",
                        lambda app, host, port: served.append((app, host, port)))
    monkeypatch.setattr(sys, "argv", ["main", "--config", _api_config(tmp_path, **search),
                                      "--port", "8123"])
    api_main.main()
    (app, host, port), = served
    ctx = app.state["ctx"]
    assert port == 8123 and ctx.config.auto_discover is False
    if search:
        assert not ctx.extra
    else:
        assert ctx.extra["semantic_index"].device == "cpu"
        assert ctx.extra["visual_index"].device == "cpu"
        assert ctx.extra["reranker"].device == "cpu"
