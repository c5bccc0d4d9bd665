"""REST API routes under /api/v1.

Copy of eioku_tpu/api/controllers.py for the PyTorch port.

Capability parity with the reference's routers:
  - videos:     backend/src/api/video_controller.py:22-148
  - artifacts:  backend/src/api/artifact_controller.py:63-451
  - paths:      backend/src/api/path_controller_full.py:36-151
  - tasks:      backend/src/api/task_routes.py:146-505
plus /api/v1/search (semantic retrieval — the layer the reference spec'd but
never shipped) and selection-policy management endpoints.
"""
from __future__ import annotations

import asyncio
import json
import os
import uuid

from pydantic import BaseModel, Field

from eioku_tpu_torch.domain.artifacts import SelectionPolicy
from eioku_tpu_torch.domain.models import PathConfig, TaskStatus, Video, VideoStatus
from eioku_tpu_torch.web.framework import (
    App,
    FileResponse,
    HTMLResponse,
    HTTPException,
    JSONResponse,
    PlainTextResponse,
    Request,
    StreamingResponse,
)

PREFIX = "/api/v1"

# /docs: self-contained interactive reference over /openapi.json. No CDN
# assets (Swagger UI's bundles can't load in zero-egress deployments); a
# ~60-line renderer covers the discovery use case the reference's /docs serves.
_DOCS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>eioku-tpu API</title><style>
body{font:14px/1.5 system-ui,sans-serif;margin:0;background:#10141c;color:#dbe2ee}
header{padding:18px 28px;border-bottom:1px solid #232b38}
h1{font-size:18px;margin:0} h2{font-size:15px;color:#7fb3ff;margin:26px 0 8px;
text-transform:capitalize} main{max-width:960px;margin:0 auto;padding:10px 28px 60px}
.op{border:1px solid #232b38;border-radius:8px;margin:6px 0;overflow:hidden}
.op summary{display:flex;gap:12px;align-items:center;padding:8px 12px;
cursor:pointer;list-style:none}
.m{font-weight:700;font-size:12px;padding:2px 10px;border-radius:6px;
min-width:52px;text-align:center}
.GET{background:#12391f;color:#6ad18b}.POST{background:#1c2e4a;color:#7fb3ff}
.PUT{background:#3a2e14;color:#ffc86a}.DELETE{background:#401c1c;color:#ff7a7a}
.PATCH{background:#2e1c40;color:#c99aff}
.path{font-family:ui-monospace,monospace;font-size:13px}
.sum{color:#8a93a6;font-size:12px;margin-left:auto;text-align:right}
.body{padding:4px 14px 12px;border-top:1px solid #232b38;color:#aeb6c6;
white-space:pre-wrap;font-size:13px}
code{background:#1a2230;padding:1px 5px;border-radius:4px}
.err{color:#ff7a7a;padding:30px}
</style></head><body>
<header><h1 id="title">eioku-tpu API</h1>
<span style="color:#8a93a6;font-size:12px">generated from
<code>/openapi.json</code></span></header>
<main id="root">Loading…</main>
<script>
fetch('/openapi.json').then(r=>r.json()).then(spec=>{
  document.getElementById('title').textContent =
    spec.info.title + ' API — v' + spec.info.version;
  const groups = {};
  for (const [path, ops] of Object.entries(spec.paths))
    for (const [method, op] of Object.entries(ops))
      (groups[(op.tags||['root'])[0]] ||= []).push({path, method, op});
  const esc = s => s.replace(/[&<>]/g, c =>
    ({'&':'&amp;','<':'&lt;','>':'&gt;'}[c]));
  document.getElementById('root').innerHTML =
    Object.entries(groups).map(([tag, ops]) => '<h2>'+esc(tag)+'</h2>' +
      ops.map(({path, method, op}) => `
      <details class="op"><summary>
        <span class="m ${method.toUpperCase()}">${method.toUpperCase()}</span>
        <span class="path">${esc(path)}</span>
        <span class="sum">${esc(op.summary||'')}</span></summary>
      <div class="body">${esc(op.description||op.summary||'')}${
        (op.parameters||[]).length ? '\\n\\npath params: ' +
        op.parameters.map(p=>p.name).join(', ') : ''}</div>
      </details>`).join('')).join('');
}).catch(e => document.getElementById('root').innerHTML =
  '<div class="err">failed to load /openapi.json: '+e+'</div>');
</script></body></html>"""


class VideoCreateBody(BaseModel):
    path: str
    file_hash: str = ""
    size_bytes: int = 0


class VideoUpdateBody(BaseModel):
    status: str | None = None


class PathCreateBody(BaseModel):
    path: str
    recursive: bool = True
    enabled: bool = True


class SelectionPolicyBody(BaseModel):
    mode: str = "latest"
    run_id: str | None = None
    model_profile: str | None = None


class TopicBody(BaseModel):
    label: str
    score: float = Field(default=0.0, ge=0.0, le=1.0)


def _selection_from_query(request: Request, ctx, asset_id: str,
                          artifact_type: str | None) -> SelectionPolicy | None:
    """Build a selection policy from query params, falling back to the stored
    per-asset policy (reference: artifact_controller.py:124-132)."""
    q = request.query_params
    run_id = q.get("run_id")
    profile = q.get("profile") or q.get("model_profile")
    mode = q.get("selection")
    try:
        if run_id:
            return SelectionPolicy(mode="pinned", run_id=run_id)
        if profile:
            return SelectionPolicy(mode="profile", model_profile=profile)
        if mode:
            return SelectionPolicy(mode=mode)
    except ValueError as e:
        raise HTTPException(422, str(e))
    if artifact_type:
        return ctx.policies.get_policy(asset_id, artifact_type)
    return None


def _attribute_speakers(ctx, asset_id: str, segments: list[dict]) -> None:
    """Annotate transcript-segment dicts in place with payload_json.speaker =
    the label of the speaker.turn overlapping each segment most (None when no
    diarization artifacts exist or nothing overlaps). Turns come from the same
    selection policy the Speakers tab uses (stored or default "latest"), so
    both views agree after a diarization re-run. Both lists arrive sorted by
    span_start_ms, so the join is a linear sweep, not O(segments x turns)."""
    turns = ctx.artifacts.get_by_asset(
        asset_id, artifact_type="speaker.turn",
        selection=ctx.policies.get_policy(asset_id, "speaker.turn"))
    if not turns:
        return
    spans = [(t.span_start_ms, t.span_end_ms, t.payload_json.get("label"))
             for t in turns]
    i = 0
    for seg in segments:
        s, e = seg["span_start_ms"], seg["span_end_ms"]
        while i < len(spans) and spans[i][1] <= s:
            i += 1
        best, best_overlap = None, 0
        for ts, te, lab in spans[i:]:
            if ts >= e:
                break
            overlap = min(e, te) - max(s, ts)
            if overlap > best_overlap:
                best, best_overlap = lab, overlap
        seg["payload_json"]["speaker"] = best


def _thumbnail_path(ctx, v, at_ms: int | None = None) -> str | None:
    """Generate (once) and return the poster-frame JPEG for a video.

    at_ms requests the frame at a specific moment (search results show the
    matched scene, spec req 3.2); cached per whole second to bound the
    on-disk cache."""
    import tempfile

    import cv2

    if ctx.db.path not in (":memory:", ""):
        base = os.path.join(os.path.dirname(os.path.abspath(ctx.db.path)),
                            "thumbnails")
    else:
        base = os.path.join(tempfile.gettempdir(), "eioku_thumbnails")
    os.makedirs(base, exist_ok=True)
    name = f"{v.id}.jpg" if at_ms is None else f"{v.id}_{int(at_ms // 1000)}.jpg"
    out = os.path.join(base, name)
    if os.path.isfile(out):
        return out
    if not os.path.isfile(v.path):
        return None
    cap = cv2.VideoCapture(v.path)
    try:
        ok, frame = False, None
        if at_ms is not None:
            cap.set(cv2.CAP_PROP_POS_MSEC, float(at_ms))
            ok, frame = cap.read()
        if not ok:
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            if n > 10:
                cap.set(cv2.CAP_PROP_POS_FRAMES, n // 10)
            ok, frame = cap.read()
            if not ok and n > 10:
                # CAP_PROP_FRAME_COUNT lies for some streams and the seek
                # lands past the end: fall back to the first decodable frame
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                ok, frame = cap.read()
        if not ok:
            return None
        h, w = frame.shape[:2]
        if w > 480:  # gallery-card size; keep the file tiny
            frame = cv2.resize(frame, (480, max(int(h * 480 / w), 2)),
                               interpolation=cv2.INTER_AREA)
        ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 82])
        if not ok:
            return None
        # unique tmp per writer: two cold requests racing on a shared ".part"
        # name can truncate each other and serve a 0-byte image
        fd, tmp = tempfile.mkstemp(suffix=".part", dir=base)
        with os.fdopen(fd, "wb") as f:
            f.write(buf.tobytes())
        os.replace(tmp, out)  # atomic publish
        return out
    finally:
        cap.release()


def _rrf_fuse(semantic: list[dict], keyword: list[dict], top_k: int,
              k: int = 60) -> list[dict]:
    """Reciprocal-rank fusion of semantic and keyword result lists: each hit
    scores sum(1 / (k + rank)) over the lists it appears in. Semantic hits
    reference embedding.chunk artifacts and keyword hits the source transcript/
    OCR artifacts, so the merge key is the video moment (5 s bucket) — the same
    moment found both ways ranks highest."""
    fused: dict[tuple, dict] = {}
    for results in (semantic, keyword):
        for rank, r in enumerate(results):
            key = (r["video_id"], r["jump_to"]["start_ms"] // 5000)
            entry = fused.setdefault(key, {**r, "score": 0.0})
            entry["score"] += 1.0 / (k + rank + 1)
    out = sorted(fused.values(), key=lambda r: r["score"], reverse=True)[:top_k]
    for r in out:
        r["score"] = round(r["score"], 6)
    return out


def register_routes(app: App, ctx) -> None:  # noqa: C901 — route table
    # -- root/health -----------------------------------------------------------

    import os

    frontend_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "frontend")
    if os.path.isdir(frontend_dir):
        # Serve the bundled SPA (the reference fronts its React build with
        # nginx, dev/nginx.conf; this framework serves its no-build SPA itself).
        app.mount_static("/static", frontend_dir)

        @app.get("/")
        async def root(request: Request):
            return FileResponse(os.path.join(frontend_dir, "index.html"),
                                media_type="text/html; charset=utf-8")
    else:
        @app.get("/")
        async def root(request: Request):
            return {"name": "eioku-tpu", "version": "0.1.0"}

    @app.get(PREFIX)
    async def api_root(request: Request):
        return {"name": "eioku-tpu", "version": "0.1.0"}

    @app.get(PREFIX + "/routes")
    async def list_routes(request: Request):
        return {"routes": sorted({f"{r.method} {r.path}" for r in app.routes})}

    @app.get("/openapi.json")
    async def openapi_spec(request: Request):
        """OpenAPI 3.1 document for the whole API surface (the reference's
        FastAPI serves the same; framework.App.openapi generates it from the
        route table)."""
        return app.openapi()

    @app.get("/docs")
    async def docs_page(request: Request):
        """Interactive API reference: self-contained HTML over /openapi.json
        (no CDN assets — this stack runs in zero-egress environments where
        Swagger UI's bundles can't load)."""
        return HTMLResponse(_DOCS_HTML)

    @app.get("/health")
    async def health(request: Request):
        out = {"status": "ok", "database": ctx.db.url}
        from eioku_tpu_torch.db.recovery import LAST_REPORT
        if LAST_REPORT.get("checked") and not LAST_REPORT.get("ok", True):
            # notify operators of detected corruption + salvage outcome
            # (spec req 7.4); status degrades but the service keeps serving
            out["status"] = "degraded"
            out["db_recovery"] = LAST_REPORT
        from eioku_tpu_torch.services.reconciler import disk_space_status
        disk = disk_space_status(
            os.path.dirname(os.path.abspath(ctx.db.path))
            if ctx.db.path not in (":memory:", "") else ".")
        out["disk"] = disk
        if disk.get("low"):  # spec req 7.5: warn before running out of space
            out["status"] = "degraded"
            out["warnings"] = ["storage volume low on space"]
        return out

    @app.get(PREFIX + "/metrics")
    async def metrics(request: Request):
        from eioku_tpu_torch.utils.metrics import METRICS, to_prometheus
        snap = METRICS.snapshot()
        snap["queue"] = ctx.producer.queue.counts()
        if request.query_params.get("format") == "prometheus":
            return PlainTextResponse(
                to_prometheus(snap),
                media_type="text/plain; version=0.0.4; charset=utf-8")
        return snap

    @app.get(PREFIX + "/device")
    async def device(request: Request):
        from eioku_tpu_torch.ml.engine import device_info
        return device_info()

    @app.get(PREFIX + "/stats")
    async def stats(request: Request):
        """Library overview in one call: video/task/artifact counts, total
        indexed duration and bytes, artifact breakdown by type, semantic
        index size. The reference has no equivalent (ops there meant psql +
        show_tasks.py); the SPA gallery header and dashboards read this."""
        def snapshot():
            # full-table aggregates can take 100s of ms on a large library;
            # off-loop like stream_tasks so the single asyncio loop keeps
            # answering other requests
            q = ctx.db.query
            videos = {r["status"]: r["n"] for r in q(
                "SELECT status, COUNT(*) AS n FROM videos GROUP BY status")}
            tasks = {r["status"]: r["n"] for r in q(
                "SELECT status, COUNT(*) AS n FROM tasks GROUP BY status")}
            artifacts = {r["artifact_type"]: r["n"] for r in q(
                "SELECT artifact_type, COUNT(*) AS n FROM artifacts"
                " GROUP BY artifact_type ORDER BY n DESC")}
            totals = q(
                "SELECT COUNT(*) AS n, COALESCE(SUM(duration_ms),0) AS dur,"
                " COALESCE(SUM(size_bytes),0) AS bytes FROM videos")[0]
            return {
                "videos": {"total": totals["n"], "by_status": videos,
                           "duration_hours": round(totals["dur"] / 3.6e6, 2),
                           "size_gb": round(totals["bytes"] / 1e9, 2)},
                "tasks": {"total": sum(tasks.values()), "by_status": tasks},
                "artifacts": {"total": sum(artifacts.values()),
                              "by_type": artifacts},
                "semantic_index": {
                    "chunks": ctx.db.scalar(
                        "SELECT COUNT(*) FROM embedding_chunks") or 0},
                "runs": ctx.db.scalar("SELECT COUNT(*) FROM runs") or 0,
            }
        return await asyncio.to_thread(snapshot)

    # -- videos ------------------------------------------------------------------

    @app.get(PREFIX + "/videos")
    async def list_videos(request: Request):
        status = request.query_params.get("status")
        try:
            status_filter = VideoStatus(status) if status else None
        except ValueError:
            raise HTTPException(422, f"unknown status: {status}")
        sort_by = request.query_params.get("sort_by", "created_at")
        if sort_by not in ("created_at", "path", "duration_ms",
                           "file_created_at", "size_bytes"):
            raise HTTPException(422, f"unknown sort_by: {sort_by}")
        name_filter = request.query_params.get("q")
        videos = ctx.videos.list(
            status=status_filter,
            sort_by=sort_by,
            descending=request.query_params.get("order", "desc") != "asc",
            name_filter=name_filter,
            limit=request.query_int("limit", 1000),
            offset=request.query_int("offset", 0))
        # total matches the active filters (pagination math), not table size
        return {"videos": [v.to_dict() for v in videos],
                "total": ctx.videos.count(status_filter, name_filter)}

    @app.post(PREFIX + "/videos")
    async def create_video(request: Request):
        body = await request.parse(VideoCreateBody)
        if ctx.videos.get_by_path(body.path) is not None:
            raise HTTPException(409, "video with this path already exists")
        v = Video(path=body.path, file_hash=body.file_hash, size_bytes=body.size_bytes)
        ctx.videos.save(v)
        return JSONResponse(v.to_dict(), 201)

    @app.put(PREFIX + "/videos/upload")
    async def upload_video(request: Request):
        """Upload a video into the library over HTTP (beyond the reference,
        which only ingests from configured filesystem paths). Raw streaming
        body — multi-GB files go straight to disk chunk by chunk, and both
        `curl -T movie.mp4 '...?filename=movie.mp4'` and the browser's
        `fetch(url, {method: "PUT", body: file})` produce it natively (no
        multipart). The file lands in the first enabled library path, then
        runs the exact discovery pipeline a scanned file would (dedup,
        hashing, task fan-out, enqueue)."""
        from eioku_tpu_torch.services.discovery import VIDEO_EXTENSIONS
        filename = request.query_params.get("filename", "")
        name = os.path.basename(filename)
        if not name or name != filename or name.startswith("."):
            raise HTTPException(422, "filename must be a plain file name")
        if os.path.splitext(name)[1].lower() not in VIDEO_EXTENSIONS:
            raise HTTPException(
                415, f"unsupported extension; expected one of "
                     f"{sorted(VIDEO_EXTENSIONS)}")
        dirs = [p.path for p in ctx.paths.list() if p.enabled]
        if not dirs:
            raise HTTPException(503, "no library path configured to receive "
                                     "uploads (add one via POST /paths)")
        dest_dir = dirs[0]
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, name)
        if os.path.exists(dest) or ctx.videos.get_by_path(dest) is not None:
            raise HTTPException(409, "a video with this filename already "
                                     "exists in the library")
        tmp = os.path.join(dest_dir, f".upload-{uuid.uuid4().hex}.part")
        written = 0
        try:
            with open(tmp, "wb") as f:
                async for chunk in request.stream():
                    f.write(chunk)
                    written += len(chunk)
            if written == 0:
                raise HTTPException(422, "empty upload body")
            os.replace(tmp, dest)  # atomic: discovery never sees a partial
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

        def ingest():
            video, _created = ctx.discovery._ensure_video(dest)
            created, enqueued = ctx.discovery.create_and_enqueue_tasks(video)
            return video, created, enqueued
        video, created, enqueued = await asyncio.to_thread(ingest)
        return JSONResponse({"video": video.to_dict(), "bytes": written,
                             "tasks_created": created,
                             "tasks_enqueued": enqueued}, 201)

    def _get_video(video_id: str) -> Video:
        v = ctx.videos.get(video_id)
        if v is None:
            raise HTTPException(404, "video not found")
        return v

    @app.get(PREFIX + "/videos/{video_id}")
    async def get_video(request: Request):
        return _get_video(request.path_params["video_id"]).to_dict()

    @app.patch(PREFIX + "/videos/{video_id}")
    async def update_video(request: Request):
        # reference: video_controller.py:76-93 — PATCH updates video status
        v = _get_video(request.path_params["video_id"])
        body = await request.parse(VideoUpdateBody)
        if body.status:
            try:
                v.status = VideoStatus(body.status)
            except ValueError:
                raise HTTPException(422, f"unknown status: {body.status}")
            ctx.videos.save(v)
        return v.to_dict()

    @app.delete(PREFIX + "/videos/{video_id}")
    async def delete_video(request: Request):
        v = _get_video(request.path_params["video_id"])
        for task in ctx.tasks.find(video_id=v.id, limit=1000):
            ctx.producer.abort_task(task.id)
        ctx.tasks.delete_for_video(v.id)
        ctx.artifacts.delete_for_asset(v.id)
        ctx.projection_sync.delete_for_asset(v.id)
        ctx.videos.delete(v.id)
        return {"deleted": v.id}

    @app.get(PREFIX + "/videos/{video_id}/stream")
    async def stream_video(request: Request):
        v = _get_video(request.path_params["video_id"])
        return FileResponse(v.path, media_type="video/mp4",
                            range_header=request.headers.get("range"))

    @app.get(PREFIX + "/videos/{video_id}/thumbnail")
    async def video_thumbnail(request: Request):
        """JPEG poster frame (beyond the reference, whose gallery shows a
        placeholder: frontend/src/components/VideoGallery.tsx:91). Grabbed at
        ~10% of the duration, cached on disk next to the database."""
        v = _get_video(request.path_params["video_id"])
        at_ms = request.query_int("at_ms", -1)
        # cold thumbnails seek+decode+encode for seconds on large files; the
        # server is a single-threaded event loop, so run it in a worker thread
        # (disk writes are atomic, so concurrent requests are safe)
        import asyncio

        path = await asyncio.to_thread(_thumbnail_path, ctx, v,
                                       at_ms if at_ms >= 0 else None)
        if path is None:
            raise HTTPException(404, "thumbnail unavailable")
        return FileResponse(path, media_type="image/jpeg")

    @app.get(PREFIX + "/videos/{video_id}/location")
    async def video_location(request: Request):
        v = _get_video(request.path_params["video_id"])
        loc = ctx.videos.get_location(v.id)
        if loc is None:
            raise HTTPException(404, "no location for this video")
        return loc

    @app.get(PREFIX + "/videos/{video_id}/tasks")
    async def video_tasks(request: Request):
        v = _get_video(request.path_params["video_id"])
        return {"tasks": [t.to_dict() for t in ctx.tasks.find(video_id=v.id, limit=1000)]}

    # -- artifacts / jump / find -----------------------------------------------------

    @app.get(PREFIX + "/videos/{video_id}/jump")
    async def jump(request: Request):
        v = _get_video(request.path_params["video_id"])
        q = request.query_params
        kind = q.get("kind")
        if not kind:
            raise HTTPException(422, "query parameter 'kind' is required")
        direction = q.get("direction", "next")
        if direction not in ("next", "prev"):
            raise HTTPException(422, "direction must be 'next' or 'prev'")
        from eioku_tpu_torch.services.jump_service import KIND_TO_ARTIFACT_TYPE
        artifact_type = KIND_TO_ARTIFACT_TYPE.get(kind, kind)
        selection = _selection_from_query(request, ctx, v.id, artifact_type)
        hit = ctx.jump.jump(
            v.id, kind, from_ms=request.query_int("from_ms", 0),
            direction=direction, label=q.get("label"),
            cluster_id=q.get("face_cluster_id") or q.get("cluster_id"),
            min_confidence=request.query_float("min_confidence"),
            selection=selection)
        if hit is None:
            return {"found": False, "jump_to": None}
        return {"found": True, "jump_to": hit}

    @app.get(PREFIX + "/videos/{video_id}/jump-options")
    async def jump_options(request: Request):
        v = _get_video(request.path_params["video_id"])
        return ctx.jump.jump_options(v.id)

    @app.get(PREFIX + "/videos/{video_id}/find")
    async def find(request: Request):
        v = _get_video(request.path_params["video_id"])
        q = request.query_params.get("q") or request.query_params.get("query")
        if not q:
            raise HTTPException(422, "query parameter 'q' is required")
        direction = request.query_params.get("direction", "next")
        matches = ctx.find.find(v.id, q, from_ms=request.query_int("from_ms", 0),
                                direction=direction)
        out = {"query": q, "matches": matches, "total": len(matches)}
        if not matches:  # spec req 2.4: suggest alternative search terms
            out["suggestions"] = ctx.find.suggest_alternatives(q)
        return out

    @app.get(PREFIX + "/videos/{video_id}/artifacts")
    async def artifacts(request: Request):
        v = _get_video(request.path_params["video_id"])
        q = request.query_params
        artifact_type = q.get("type") or q.get("artifact_type")
        payload_filters = {}
        if q.get("label"):
            payload_filters["label"] = q["label"]
        selection = None
        if artifact_type and not q.get("run_id"):
            selection = _selection_from_query(request, ctx, v.id, artifact_type)
        envs = ctx.artifacts.get_by_asset(
            v.id, artifact_type=artifact_type,
            start_ms=request.query_int("start_ms"),
            end_ms=request.query_int("end_ms"),
            run_id=q.get("run_id"),
            payload_filters=payload_filters or None,
            selection=selection,
            limit=request.query_int("limit", 10000),
            offset=request.query_int("offset", 0))
        out = [e.to_dict() for e in envs]
        if artifact_type == "transcript.segment" and \
                q.get("with_speakers") in ("1", "true"):
            # who-said-what: join each segment with the diarized speaker turn
            # that overlaps it most (read-time enrichment; envelopes stay
            # immutable)
            _attribute_speakers(ctx, v.id, out)
        return {"artifacts": out, "total": len(out)}

    @app.get(PREFIX + "/people")
    async def people(request: Request):
        """Cross-video face identities: ArcFace track centroids clustered
        library-wide (services/people.py). ?threshold= tunes the cosine
        distance cutoff (default 0.45). Needs face_detection runs with
        {"embeddings": true}; returns [] otherwise."""
        from eioku_tpu_torch.services.people import DEFAULT_THRESHOLD, PeopleService
        svc = ctx.extra.get("people_service")
        if svc is None:
            svc = ctx.extra["people_service"] = PeopleService(ctx)
        try:
            threshold = float(request.query_params.get(
                "threshold", DEFAULT_THRESHOLD))
        except ValueError:
            raise HTTPException(422, "threshold must be a number")
        persons = await asyncio.to_thread(svc.people, threshold)
        return {"people": persons, "total": len(persons)}

    @app.get(PREFIX + "/videos/{video_id}/clip")
    async def clip(request: Request):
        """Export [start_ms, end_ms] as a downloadable clip: native
        stream-copy remux (no re-encode, cut snaps to the keyframe at or
        before start_ms), cached per (file, span). Spans cap at 10 min."""
        from eioku_tpu_torch.services.clips import MAX_CLIP_MS, clip_path
        v = _get_video(request.path_params["video_id"])
        start_ms = request.query_int("start_ms", 0)
        end_ms = request.query_int("end_ms")
        if end_ms is None:
            raise HTTPException(422, "end_ms is required")
        if end_ms <= start_ms or start_ms < 0:
            raise HTTPException(422, "end_ms must be greater than start_ms")
        if end_ms - start_ms > MAX_CLIP_MS:
            raise HTTPException(422, f"clip span is capped at {MAX_CLIP_MS} ms")
        if not os.path.isfile(v.path):
            raise HTTPException(404, "video file is missing on disk")
        path = await asyncio.to_thread(clip_path, v.path, v.file_hash,
                                       start_ms, end_ms)
        if path is None:
            raise HTTPException(500, "clip export failed")
        base = os.path.splitext(os.path.basename(v.path))[0]
        clip_ext = os.path.splitext(path)[1].lower()
        media = {".mkv": "video/x-matroska", ".webm": "video/webm",
                 ".mov": "video/quicktime"}.get(clip_ext, "video/mp4")
        return FileResponse(
            path, media_type=media,
            download_name=f"{base}_{start_ms}_{end_ms}{clip_ext}")

    @app.get(PREFIX + "/videos/{video_id}/subtitles")
    async def subtitles(request: Request):
        """Transcript as a standard subtitle file: ?format=vtt (default) or
        srt, ?language= filters multi-language transcripts, ?with_speakers=1
        prefixes diarized speaker labels. Uses the same selection policy as
        the Transcript tab; the SPA player attaches the VTT as a native
        captions <track>."""
        v = _get_video(request.path_params["video_id"])
        fmt = request.query_params.get("format", "vtt")
        if fmt not in ("vtt", "srt"):
            raise HTTPException(422, f"unknown subtitle format: {fmt}")
        lang = request.query_params.get("language")
        envs = ctx.artifacts.get_by_asset(
            v.id, artifact_type="transcript.segment",
            payload_filters={"language": lang} if lang else None,
            selection=ctx.policies.get_policy(v.id, "transcript.segment"),
            limit=100000)
        segs = [e.to_dict() for e in envs]
        if request.query_params.get("with_speakers") in ("1", "true"):
            _attribute_speakers(ctx, v.id, segs)
        from eioku_tpu_torch.services.subtitles import to_srt, to_vtt
        if fmt == "srt":
            return PlainTextResponse(
                to_srt(segs), media_type="application/x-subrip",
                headers={"content-disposition":
                         f'attachment; filename="{v.id}.srt"'})
        return PlainTextResponse(to_vtt(segs), media_type="text/vtt")

    @app.get(PREFIX + "/videos/{video_id}/artifact_types")
    async def artifact_types(request: Request):
        v = _get_video(request.path_params["video_id"])
        return {"types": ctx.artifacts.list_types_for_asset(v.id)}

    @app.get(PREFIX + "/videos/{video_id}/profiles")
    async def profiles(request: Request):
        v = _get_video(request.path_params["video_id"])
        return {"profiles": ctx.artifacts.list_profiles(
            v.id, request.query_params.get("artifact_type"))}

    @app.get(PREFIX + "/videos/{video_id}/runs")
    async def runs(request: Request):
        v = _get_video(request.path_params["video_id"])
        return {"runs": ctx.artifacts.list_runs(
            v.id, request.query_params.get("artifact_type"))}

    @app.get(PREFIX + "/videos/{video_id}/selection/{artifact_type}")
    async def get_selection(request: Request):
        v = _get_video(request.path_params["video_id"])
        policy = ctx.policies.get_policy(v.id, request.path_params["artifact_type"])
        return policy.to_dict()

    @app.put(PREFIX + "/videos/{video_id}/selection/{artifact_type}")
    async def set_selection(request: Request):
        v = _get_video(request.path_params["video_id"])
        body = await request.parse(SelectionPolicyBody)
        try:
            policy = SelectionPolicy(mode=body.mode, run_id=body.run_id,
                                     model_profile=body.model_profile)
        except ValueError as e:
            raise HTTPException(422, str(e))
        ctx.policies.set_policy(v.id, request.path_params["artifact_type"], policy)
        return policy.to_dict()

    @app.delete(PREFIX + "/videos/{video_id}/selection/{artifact_type}")
    async def clear_selection(request: Request):
        v = _get_video(request.path_params["video_id"])
        cleared = ctx.policies.clear_policy(v.id,
                                            request.path_params["artifact_type"])
        return {"cleared": cleared}

    # -- paths -------------------------------------------------------------------------

    @app.get(PREFIX + "/paths")
    async def list_paths(request: Request):
        return {"paths": [p.to_dict() for p in ctx.paths.list()]}

    @app.post(PREFIX + "/paths")
    async def add_path(request: Request):
        body = await request.parse(PathCreateBody)
        pc = PathConfig(path=body.path, recursive=body.recursive, enabled=body.enabled)
        ctx.paths.save(pc)
        return JSONResponse(ctx.paths.get_by_path(body.path).to_dict(), 201)

    @app.delete(PREFIX + "/paths")
    async def delete_path(request: Request):
        path = request.query_params.get("path")
        if not path:
            raise HTTPException(422, "query parameter 'path' is required")
        if not ctx.paths.delete(path):
            raise HTTPException(404, "path not configured")
        return {"deleted": path}

    @app.post(PREFIX + "/paths/discover")
    async def discover(request: Request):
        report = ctx.discovery.discover()
        return report.to_dict()

    @app.post(PREFIX + "/paths/validate")
    async def validate_paths(request: Request):
        report = ctx.discovery.validate_existing()
        return report.to_dict()

    # -- tasks ----------------------------------------------------------------------------

    @app.get(PREFIX + "/tasks")
    async def list_tasks(request: Request):
        q = request.query_params
        limit = min(request.query_int("limit", 100), 100)  # reference caps at 100
        status = q.get("status")
        try:
            status_filter = TaskStatus(status) if status else None
        except ValueError:
            raise HTTPException(422, f"unknown status: {status}")
        tasks = ctx.tasks.find(
            video_id=q.get("video_id"),
            status=status_filter,
            task_type=q.get("task_type"),
            language=q.get("language"),
            sort_by=q.get("sort_by", "created_at"),
            descending=not request.query_bool("ascending"),
            limit=limit, offset=request.query_int("offset", 0))
        return {"tasks": [t.to_dict() for t in tasks], "total": ctx.tasks.count()}

    @app.get(PREFIX + "/tasks/stream")
    async def stream_tasks(request: Request):
        """Live task progress as Server-Sent Events: one `data:` event per
        change in the (status x type) counts plus the most recent tasks —
        the SPA's Tasks tab updates without polling (the reference's SPA
        polls /tasks). ?interval= (seconds, default 1, min 0.2),
        ?timeout= caps the stream (default 300 s), ?max_events= for
        bounded reads. Heartbeat comments keep proxies from idling out."""
        import math as _math
        interval = request.query_float("interval", 1.0)
        timeout = request.query_float("timeout", 300.0)
        if not (_math.isfinite(interval) and _math.isfinite(timeout)):
            raise HTTPException(422, "interval/timeout must be finite")
        timeout = min(max(timeout, 0.0), 3600.0)
        # interval can never exceed the stream lifetime (inf/NaN rejected
        # above; an interval above timeout would sleep past the deadline)
        interval = min(max(interval, 0.2), max(timeout, 0.2))
        max_events = request.query_int("max_events", 0)

        def snapshot():
            counts: dict[str, int] = {}
            for row in ctx.db.query(
                    "SELECT status, COUNT(*) AS n FROM tasks GROUP BY status"):
                counts[row["status"]] = row["n"]
            recent = [t.to_dict() for t in ctx.tasks.find(
                limit=20, sort_by="created_at", descending=True)]
            return {"counts": counts, "recent": recent}

        async def events():
            import asyncio as _asyncio
            import time as _time
            deadline = _time.monotonic() + timeout
            last, sent, beats = None, 0, 0
            while _time.monotonic() < deadline:
                snap = await _asyncio.to_thread(snapshot)
                if snap != last:
                    last = snap
                    yield f"data: {json.dumps(snap)}\n\n"
                    sent += 1
                    if max_events and sent >= max_events:
                        return
                else:
                    beats += 1
                    if beats % 15 == 0:
                        yield ": keepalive\n\n"
                await _asyncio.sleep(interval)

        return StreamingResponse(
            events(), media_type="text/event-stream",
            headers={"cache-control": "no-cache", "x-accel-buffering": "no"})

    def _get_task(task_id: str):
        t = ctx.tasks.get(task_id)
        if t is None:
            raise HTTPException(404, "task not found")
        return t

    @app.get(PREFIX + "/tasks/{task_id}")
    async def get_task(request: Request):
        return _get_task(request.path_params["task_id"]).to_dict()

    @app.post(PREFIX + "/tasks/{task_id}/enqueue")
    async def enqueue_task(request: Request):
        t = _get_task(request.path_params["task_id"])
        if t.status is not TaskStatus.PENDING:
            raise HTTPException(409, f"task is {t.status.value}, only pending tasks"
                                " can be enqueued")
        video = ctx.videos.get(t.video_id)
        if video is None:
            raise HTTPException(404, "video not found")
        job = ctx.producer.enqueue_task(t.id, t.task_type, t.video_id, video.path,
                                        t.config, priority=t.priority)
        return {"enqueued": job is not None, "job_id": ctx.producer.job_id_for_task(t.id)}

    @app.post(PREFIX + "/tasks/{task_id}/cancel")
    async def cancel_task(request: Request):
        t = _get_task(request.path_params["task_id"])
        if t.status not in (TaskStatus.PENDING, TaskStatus.RUNNING):
            raise HTTPException(409, f"task is {t.status.value}, only pending/running"
                                " tasks can be cancelled")
        ctx.producer.abort_task(t.id)
        ctx.tasks.update_status(t.id, TaskStatus.CANCELLED)
        return ctx.tasks.get(t.id).to_dict()

    @app.post(PREFIX + "/tasks/{task_id}/retry")
    async def retry_task(request: Request):
        t = _get_task(request.path_params["task_id"])
        if t.status not in (TaskStatus.FAILED, TaskStatus.CANCELLED):
            raise HTTPException(409, f"task is {t.status.value}, only failed/cancelled"
                                " tasks can be retried")
        ctx.tasks.update_status(t.id, TaskStatus.PENDING)
        video = ctx.videos.get(t.video_id)
        if video is not None:
            ctx.producer.enqueue_task(t.id, t.task_type, t.video_id, video.path,
                                      t.config, priority=t.priority)
        return ctx.tasks.get(t.id).to_dict()

    @app.post(PREFIX + "/tasks/reconcile")
    async def reconcile(request: Request):
        return ctx.reconciler.run().to_dict()

    # -- topics (reference has the table, spec'd Req 9; exposed here) -------------------

    @app.get(PREFIX + "/videos/{video_id}/topics")
    async def list_topics(request: Request):
        v = _get_video(request.path_params["video_id"])
        rows = ctx.db.query(
            "SELECT id, label, score, created_at FROM topics WHERE asset_id=?"
            " ORDER BY score DESC", (v.id,))
        return {"topics": [dict(r) for r in rows]}

    @app.get(PREFIX + "/videos/{video_id}/similar")
    async def similar_moments(request: Request):
        """Visually similar moments across the library, anchored at the
        indexed keyframe nearest ?at_ms= (CLIP embedding already in the
        index — no model call at query time). Beyond the reference."""
        v = _get_video(request.path_params["video_id"])
        vindex = ctx.extra.get("visual_index")
        if vindex is None:
            raise HTTPException(
                503, "visual index not available on this deployment")
        at_ms = request.query_int("at_ms", 0)
        top_k = min(request.query_int("top_k", 10), 100)
        results = await asyncio.to_thread(vindex.similar, v.id, at_ms, top_k)
        return {"video_id": v.id, "at_ms": at_ms, "results": results,
                "total": len(results)}

    # -- semantic search (new layer; engine attaches when index is built) ---------------

    @app.get(PREFIX + "/search")
    async def search(request: Request):
        q = request.query_params.get("q")
        if not q:
            raise HTTPException(422, "query parameter 'q' is required")
        mode = request.query_params.get("mode", "semantic")
        if mode not in ("semantic", "keyword", "hybrid", "visual"):
            raise HTTPException(422, f"unknown search mode: {mode}")
        top_k = min(request.query_int("top_k", 10), 100)
        asset_id = request.query_params.get("video_id")
        # ?rerank=1: cross-encoder second stage (index/rerank.py) — over-fetch
        # candidates so the reranker has headroom beyond the retrieval order;
        # gated on a real ms-marco checkpoint (degrades to retrieval order).
        # Checkpoint load + first compile run off-loop: the server is one
        # asyncio loop and must keep answering while they warm up.
        rerank_requested = request.query_params.get("rerank") in ("1", "true")
        reranker = ctx.extra.get("reranker") if rerank_requested else None
        reranking = bool(
            reranker is not None
            and await asyncio.to_thread(lambda: reranker.available))
        # never fetch fewer than top_k: only the first MAX_CANDIDATES are
        # rescored, the rest keep retrieval order behind them
        fetch_k = max(top_k, min(top_k * 3, 64)) if reranking else top_k
        keyword = []
        if mode in ("keyword", "hybrid"):
            keyword = ctx.find.search_library(q, limit=fetch_k, asset_id=asset_id)
        semantic = []
        if mode in ("semantic", "hybrid"):
            index = ctx.extra.get("semantic_index")
            if index is None:
                if mode == "semantic":
                    raise HTTPException(
                        503, "semantic index not available on this deployment")
            else:
                semantic = index.search(q, top_k=fetch_k, asset_id=asset_id)
        if mode == "visual":
            # CLIP text->keyframe retrieval (index/visual.py); a text-only
            # reranker can't rescore image moments, so rerank is a no-op here
            vindex = ctx.extra.get("visual_index")
            if vindex is None:
                raise HTTPException(
                    503, "visual index not available on this deployment")
            results = await asyncio.to_thread(
                vindex.search, q, top_k, asset_id)
            reranking = False
        elif mode == "keyword":
            results = keyword
        elif mode == "semantic":
            results = semantic
        else:
            results = _rrf_fuse(semantic, keyword, fetch_k)
        if reranking:
            results = await asyncio.to_thread(reranker.rerank, q, results,
                                              top_k)
        results = results[:top_k]
        out = {"query": q, "mode": mode, "results": results,
               "total": len(results)}
        if rerank_requested:
            out["reranked"] = reranking
        if not results:  # spec req 2.4: suggest alternative search terms
            out["suggestions"] = ctx.find.suggest_alternatives(q)
        return out
