"""First-party ASGI micro web framework.

Copy of eioku_tpu/web/framework.py for the PyTorch port.

The reference serves its API with FastAPI + uvicorn/gunicorn
(backend/src/main_api.py:226-248). Neither is a dependency of this
package, so this framework implements the ASGI application side itself:
routing with typed path parameters, JSON request/response handling, pydantic
model validation for bodies and responses, HTTP Range support for video
streaming, and a lifespan protocol. It runs under any ASGI server — including
the bundled asyncio server (eioku_tpu_torch.web.server) and httpx.ASGITransport for
in-process tests (mirroring the reference's TestClient strategy,
backend/tests/test_api.py:14-60).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import traceback
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qs, unquote

from pydantic import BaseModel, ValidationError

log = logging.getLogger(__name__)


class HTTPException(Exception):
    def __init__(self, status_code: int, detail: str = ""):
        self.status_code = status_code
        self.detail = detail or {404: "Not Found", 400: "Bad Request",
                                 409: "Conflict", 422: "Unprocessable Entity",
                                 500: "Internal Server Error"}.get(status_code, "Error")
        super().__init__(self.detail)


class Request:
    def __init__(self, scope: dict, receive: Callable):
        self.scope = scope
        self._receive = receive
        self.path_params: dict[str, str] = {}
        self._body: bytes | None = None

    @property
    def method(self) -> str:
        return self.scope["method"]

    @property
    def path(self) -> str:
        return self.scope["path"]

    @property
    def headers(self) -> dict[str, str]:
        return {k.decode("latin-1").lower(): v.decode("latin-1")
                for k, v in self.scope.get("headers", [])}

    @property
    def query_params(self) -> dict[str, str]:
        qs = self.scope.get("query_string", b"").decode()
        return {k: v[0] for k, v in parse_qs(qs, keep_blank_values=True).items()}

    def query_int(self, name: str, default: int | None = None) -> int | None:
        raw = self.query_params.get(name)
        if raw is None or raw == "":
            return default
        try:
            return int(raw)
        except ValueError:
            raise HTTPException(422, f"query parameter {name!r} must be an integer")

    def query_float(self, name: str, default: float | None = None) -> float | None:
        raw = self.query_params.get(name)
        if raw is None or raw == "":
            return default
        try:
            return float(raw)
        except ValueError:
            raise HTTPException(422, f"query parameter {name!r} must be a number")

    def query_bool(self, name: str, default: bool = False) -> bool:
        raw = self.query_params.get(name)
        if raw is None:
            return default
        return raw.lower() in ("1", "true", "yes", "on")

    async def body(self) -> bytes:
        if self._body is None:
            chunks = []
            async for chunk in self.stream():
                chunks.append(chunk)
            self._body = b"".join(chunks)
        return self._body

    async def stream(self):
        """Yield raw body chunks without buffering — multi-GB uploads go
        straight to disk instead of resident memory. Single-shot: once
        consumed (by stream() or body()), the body is gone."""
        if self._body is not None:
            yield self._body
            return
        while True:
            message = await self._receive()
            chunk = message.get("body", b"")
            if chunk:
                yield chunk
            if not message.get("more_body", False):
                return

    async def json(self) -> Any:
        raw = await self.body()
        if not raw:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            raise HTTPException(400, "invalid JSON body")

    async def parse(self, model: type[BaseModel]) -> BaseModel:
        data = await self.json()
        try:
            return model.model_validate(data or {})
        except ValidationError as e:
            raise HTTPException(422, f"validation error: {e.error_count()} error(s): "
                                + "; ".join(f"{'.'.join(map(str, err['loc']))}: {err['msg']}"
                                            for err in e.errors()[:5]))


class Response:
    media_type = "application/octet-stream"

    def __init__(self, content: bytes | str = b"", status_code: int = 200,
                 headers: dict[str, str] | None = None, media_type: str | None = None):
        self.body = content.encode() if isinstance(content, str) else content
        self.status_code = status_code
        self.headers = headers or {}
        if media_type:
            self.media_type = media_type

    def _header_list(self) -> list[tuple[bytes, bytes]]:
        out = [(b"content-type", self.media_type.encode()),
               (b"content-length", str(len(self.body)).encode())]
        out.extend((k.lower().encode(), v.encode()) for k, v in self.headers.items())
        return out

    async def send(self, send: Callable) -> None:
        await send({"type": "http.response.start", "status": self.status_code,
                    "headers": self._header_list()})
        await send({"type": "http.response.body", "body": self.body})


class JSONResponse(Response):
    media_type = "application/json"

    def __init__(self, content: Any = None, status_code: int = 200,
                 headers: dict[str, str] | None = None):
        if isinstance(content, BaseModel):
            body = content.model_dump_json().encode()
        else:
            body = json.dumps(content, default=str).encode()
        super().__init__(body, status_code, headers)


class PlainTextResponse(Response):
    media_type = "text/plain; charset=utf-8"


class HTMLResponse(Response):
    media_type = "text/html; charset=utf-8"


class StreamingResponse(Response):
    """Incremental body from an async generator (SSE, long downloads). The
    server already speaks more_body (FileResponse uses it); this exposes it
    for generated content. No content-length: the connection closes (or the
    client stops reading) when the generator ends.

    The app sets `_receive` before send(): a watcher task awaits
    http.disconnect and aborts the generator, so a long-lived stream (e.g. a
    one-hour SSE subscription) stops polling the moment the client goes away
    instead of running out its timeout."""

    media_type = "application/octet-stream"

    def __init__(self, content, status_code: int = 200,
                 headers: dict[str, str] | None = None,
                 media_type: str | None = None):
        super().__init__(b"", status_code, headers, media_type)
        self.content = content
        self._receive: Callable | None = None

    def _header_list(self) -> list[tuple[bytes, bytes]]:
        out = [(b"content-type", self.media_type.encode())]
        out.extend((k.lower().encode(), v.encode())
                   for k, v in self.headers.items())
        return out

    async def send(self, send: Callable) -> None:
        import asyncio

        await send({"type": "http.response.start",
                    "status": self.status_code,
                    "headers": self._header_list()})
        disconnected = asyncio.Event()

        async def watch() -> None:
            while True:
                try:
                    msg = await self._receive()
                except Exception:
                    break
                if msg["type"] == "http.disconnect":
                    break
            disconnected.set()

        watcher = asyncio.ensure_future(watch()) if self._receive else None
        it = self.content.__aiter__()
        dc_wait = asyncio.ensure_future(disconnected.wait())
        try:
            while not disconnected.is_set():
                nxt = asyncio.ensure_future(it.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, dc_wait}, return_when=asyncio.FIRST_COMPLETED)
                if nxt not in done:
                    nxt.cancel()
                    log.info("streaming response aborted: client disconnected")
                    break
                try:
                    chunk = nxt.result()
                except StopAsyncIteration:
                    break
                body = chunk.encode() if isinstance(chunk, str) else chunk
                await send({"type": "http.response.body", "body": body,
                            "more_body": True})
            if not disconnected.is_set():
                await send({"type": "http.response.body", "body": b""})
        finally:
            dc_wait.cancel()
            if watcher is not None:
                watcher.cancel()
            aclose = getattr(it, "aclose", None)
            if aclose is not None:
                with contextlib.suppress(Exception):
                    await aclose()


_CHUNK = 1 << 18  # 256 KiB


class FileResponse(Response):
    """Streaming file response with HTTP Range support (single range), used for
    video playback (reference: video_controller.py:108-134 serves FileResponse
    with Accept-Ranges)."""

    def __init__(self, path: str, media_type: str = "video/mp4",
                 range_header: str | None = None, download_name: str | None = None):
        super().__init__(b"", 200)
        self.path = path
        self.media_type = media_type
        self.range_header = range_header
        self.download_name = download_name

    async def send(self, send: Callable) -> None:
        if not os.path.isfile(self.path):
            await JSONResponse({"detail": "file not found"}, 404).send(send)
            return
        size = os.path.getsize(self.path)
        start, end = 0, size - 1
        status = 200
        headers = [(b"accept-ranges", b"bytes"),
                   (b"content-type", self.media_type.encode())]
        if self.download_name:
            headers.append((b"content-disposition",
                            f'inline; filename="{self.download_name}"'.encode()))
        if self.range_header:
            m = re.match(r"bytes=(\d*)-(\d*)$", self.range_header.strip())
            if m and (m.group(1) or m.group(2)):
                if m.group(1):
                    start = int(m.group(1))
                    if m.group(2):
                        end = min(int(m.group(2)), size - 1)
                else:  # suffix range: last N bytes
                    n = int(m.group(2))
                    start = max(size - n, 0)
                if start >= size:
                    await Response(b"", 416,
                                   {"content-range": f"bytes */{size}"}).send(send)
                    return
                if end < start:
                    # RFC 9110: an invalid (inverted) range is ignored —
                    # serve the full representation with 200
                    start, end = 0, size - 1
                else:
                    status = 206
                    headers.append(
                        (b"content-range",
                         f"bytes {start}-{end}/{size}".encode()))
        length = end - start + 1
        headers.append((b"content-length", str(length).encode()))
        await send({"type": "http.response.start", "status": status, "headers": headers})
        with open(self.path, "rb") as f:
            f.seek(start)
            remaining = length
            while remaining > 0:
                chunk = f.read(min(_CHUNK, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
                await send({"type": "http.response.body", "body": chunk,
                            "more_body": remaining > 0})
            if remaining > 0:  # file truncated mid-stream
                await send({"type": "http.response.body", "body": b""})


Handler = Callable[[Request], Awaitable[Response]]

_PARAM_RE = re.compile(r"\{(\w+)\}")


def _compile_path(pattern: str) -> re.Pattern:
    regex = _PARAM_RE.sub(lambda m: f"(?P<{m.group(1)}>[^/]+)", pattern)
    return re.compile(f"^{regex}$")


class Route:
    def __init__(self, path: str, method: str, handler: Handler):
        self.path = path
        self.method = method.upper()
        self.handler = handler
        self.regex = _compile_path(path)


class App:
    """ASGI application with routing + lifespan."""

    def __init__(self, title: str = "eioku-tpu"):
        self.title = title
        self.routes: list[Route] = []
        self.on_startup: list[Callable[[], Awaitable[None]]] = []
        self.on_shutdown: list[Callable[[], Awaitable[None]]] = []
        self.state: dict[str, Any] = {}

    # -- registration -----------------------------------------------------------

    def add_route(self, path: str, handler: Handler, methods: list[str]) -> None:
        for m in methods:
            self.routes.append(Route(path, m, handler))

    def get(self, path: str):
        return self._decorator(path, "GET")

    def post(self, path: str):
        return self._decorator(path, "POST")

    def put(self, path: str):
        return self._decorator(path, "PUT")

    def delete(self, path: str):
        return self._decorator(path, "DELETE")

    def patch(self, path: str):
        return self._decorator(path, "PATCH")

    def _decorator(self, path: str, method: str):
        def wrap(fn: Handler) -> Handler:
            self.add_route(path, fn, [method])
            return fn
        return wrap

    def openapi(self, version: str | None = None) -> dict:
        """OpenAPI 3.1 document generated from the route table (paths, methods,
        path parameters, handler-docstring summaries). Capability parity: the
        reference's FastAPI auto-serves /openapi.json + /docs for its whole
        surface; this framework derives the same discovery document from its
        own registry. Query/body schemas are documented in prose (docs/API.md)
        — handlers parse them imperatively, so only the route surface is
        introspectable."""
        paths: dict[str, dict] = {}
        for r in self.routes:
            if "{filepath}" in r.path:  # static mounts aren't API surface
                continue
            doc = (r.handler.__doc__ or "").strip()
            summary = doc.splitlines()[0] if doc else r.handler.__name__
            op = {
                "summary": summary,
                "operationId": f"{r.method.lower()}_" + re.sub(
                    r"\W+", "_", r.path).strip("_"),
                "responses": {"200": {"description": "Successful response"}},
            }
            if doc.count("\n"):
                op["description"] = doc
            params = _PARAM_RE.findall(r.path)
            if params:
                op["parameters"] = [{"name": p, "in": "path", "required": True,
                                     "schema": {"type": "string"}}
                                    for p in params]
            tag = r.path.split("/")[3] if r.path.startswith("/api/") \
                and len(r.path.split("/")) > 3 else "root"
            op["tags"] = [tag]
            paths.setdefault(r.path, {})[r.method.lower()] = op
        if version is None:
            from eioku_tpu_torch import __version__ as version  # one source of truth
        return {"openapi": "3.1.0",
                "info": {"title": self.title, "version": version},
                "paths": dict(sorted(paths.items()))}

    def mount_static(self, prefix: str, directory: str,
                     index: str = "index.html") -> None:
        """Serve files under `directory` at `prefix` (the reference fronts its SPA
        with nginx, dev/nginx.conf:1-50; this framework serves it directly)."""
        prefix = prefix.rstrip("/")

        async def serve(request: Request) -> Response:
            rel = unquote(request.path_params.get("filepath", "") or index)
            full = os.path.realpath(os.path.join(directory, rel))
            if not full.startswith(os.path.realpath(directory) + os.sep) and \
                    full != os.path.realpath(directory):
                raise HTTPException(404)
            if os.path.isdir(full):
                full = os.path.join(full, index)
            if not os.path.isfile(full):
                raise HTTPException(404)
            media = {
                ".html": "text/html; charset=utf-8",
                ".js": "application/javascript",
                ".css": "text/css",
                ".json": "application/json",
                ".svg": "image/svg+xml",
                ".png": "image/png",
                ".ico": "image/x-icon",
            }.get(os.path.splitext(full)[1].lower(), "application/octet-stream")
            return FileResponse(full, media_type=media,
                                range_header=request.headers.get("range"))

        self.add_route(prefix + "/", serve, ["GET"])
        self.add_route(prefix + "/{filepath}", serve, ["GET"])
        # allow nested paths: {filepath} won't match "/", so add a catch-all regex
        route = Route(prefix + "/{filepath}", "GET", serve)
        route.regex = re.compile(f"^{re.escape(prefix)}/(?P<filepath>.+)$")
        self.routes.append(route)

    # -- ASGI -----------------------------------------------------------------------

    async def __call__(self, scope: dict, receive: Callable, send: Callable) -> None:
        if scope["type"] == "lifespan":
            await self._lifespan(receive, send)
            return
        if scope["type"] != "http":
            return
        request = Request(scope, receive)
        try:
            response = await self._dispatch(request)
        except HTTPException as e:
            response = JSONResponse({"detail": e.detail}, e.status_code)
        except Exception:
            log.error("unhandled error %s %s\n%s", scope.get("method"),
                      scope.get("path"), traceback.format_exc())
            response = JSONResponse({"detail": "Internal Server Error"}, 500)
        if isinstance(response, StreamingResponse):
            response._receive = receive  # disconnect watch (send() docstring)
        await response.send(send)

    async def _dispatch(self, request: Request) -> Response:
        path = request.path.rstrip("/") or "/"
        allowed: set[str] = set()
        for route in self.routes:
            m = route.regex.match(path) or route.regex.match(request.path)
            if m:
                if route.method == request.method:
                    request.path_params = {k: unquote(v)
                                           for k, v in m.groupdict().items()}
                    result = await route.handler(request)
                    if isinstance(result, Response):
                        return result
                    if isinstance(result, (dict, list, BaseModel)):
                        return JSONResponse(result)
                    raise HTTPException(500, "handler returned non-response")
                allowed.add(route.method)
        if allowed:
            return JSONResponse({"detail": "Method Not Allowed"}, 405,
                                {"allow": ", ".join(sorted(allowed))})
        raise HTTPException(404)

    async def _lifespan(self, receive: Callable, send: Callable) -> None:
        while True:
            message = await receive()
            if message["type"] == "lifespan.startup":
                try:
                    for fn in self.on_startup:
                        await fn()
                    await send({"type": "lifespan.startup.complete"})
                except Exception as e:
                    log.exception("startup failed")
                    await send({"type": "lifespan.startup.failed", "message": str(e)})
            elif message["type"] == "lifespan.shutdown":
                try:
                    for fn in self.on_shutdown:
                        await fn()
                    await send({"type": "lifespan.shutdown.complete"})
                except Exception as e:
                    await send({"type": "lifespan.shutdown.failed", "message": str(e)})
                return
