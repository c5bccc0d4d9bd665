"""Minimal asyncio HTTP/1.1 server speaking ASGI.

Copy of eioku_tpu/web/server.py for the PyTorch port.

Replaces uvicorn/gunicorn from the reference deployment
(dev/docker-compose.yml:75, gunicorn.conf.py). Supports
keep-alive, streaming response bodies (more_body), and graceful shutdown; it is
intentionally small — the API is metadata-plane, the data plane is the inference
engine.
"""
from __future__ import annotations

import asyncio
import logging
from urllib.parse import unquote, urlsplit

log = logging.getLogger(__name__)

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 512 * 1024 * 1024


class _Connection:
    def __init__(self, app, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.app = app
        self.reader = reader
        self.writer = writer

    async def handle(self) -> None:
        try:
            while True:
                keep_alive = await self._handle_one()
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            log.exception("connection error")
        finally:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass

    async def _handle_one(self) -> bool:
        request_line = await self.reader.readline()
        if not request_line or request_line in (b"\r\n", b"\n"):
            return False
        try:
            method, target, version = request_line.decode("latin-1").strip().split(" ", 2)
        except ValueError:
            await self._simple_response(400, b"Bad Request")
            return False

        headers: list[tuple[bytes, bytes]] = []
        total = 0
        while True:
            line = await self.reader.readline()
            total += len(line)
            if total > _MAX_HEADER_BYTES:
                await self._simple_response(431, b"Headers Too Large")
                return False
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.partition(b":")
            headers.append((name.strip().lower(), value.strip()))

        hmap = dict(headers)
        content_length = int(hmap.get(b"content-length", b"0") or 0)
        if content_length > _MAX_BODY_BYTES:
            await self._simple_response(413, b"Payload Too Large")
            return False
        body = await self.reader.readexactly(content_length) if content_length else b""

        parts = urlsplit(target)
        keep_alive = hmap.get(b"connection", b"").lower() != b"close" and \
            version.upper() != "HTTP/1.0"

        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": version.split("/")[-1],
            "method": method.upper(),
            "scheme": "http",
            "path": unquote(parts.path),
            "raw_path": parts.path.encode(),
            "query_string": parts.query.encode(),
            "headers": headers,
            "client": self.writer.get_extra_info("peername"),
            "server": self.writer.get_extra_info("sockname"),
        }

        body_sent = False

        async def receive():
            nonlocal body_sent
            if body_sent:
                # ASGI semantics: after the body, receive() resolves only on
                # actual client disconnect. Streaming handlers watch this to
                # stop work when the peer goes away. Reading ahead is safe
                # here: streams carry connection: close (no content-length),
                # so no pipelined request follows on this socket.
                try:
                    await self.reader.read(1)
                except Exception:
                    pass
                return {"type": "http.disconnect"}
            body_sent = True
            return {"type": "http.request", "body": body, "more_body": False}

        state = {"started": False, "length_known": False}

        async def send(message):
            if message["type"] == "http.response.start":
                state["started"] = True
                status = message["status"]
                hdrs = list(message.get("headers", []))
                names = {k.lower() for k, _ in hdrs}
                if b"content-length" not in names:
                    hdrs.append((b"connection", b"close"))
                else:
                    state["length_known"] = True
                    hdrs.append((b"connection",
                                 b"keep-alive" if keep_alive else b"close"))
                head = [f"HTTP/1.1 {status} {_reason(status)}".encode()]
                head.extend(k + b": " + v for k, v in hdrs)
                self.writer.write(b"\r\n".join(head) + b"\r\n\r\n")
            elif message["type"] == "http.response.body":
                self.writer.write(message.get("body", b""))
                if not message.get("more_body", False):
                    await self.writer.drain()
                elif self.writer.transport.get_write_buffer_size() > (1 << 20):
                    await self.writer.drain()

        await self.app(scope, receive, send)
        if not state["started"]:
            await self._simple_response(500, b"No Response")
            return False
        return keep_alive and state["length_known"]

    async def _simple_response(self, status: int, text: bytes) -> None:
        self.writer.write(
            f"HTTP/1.1 {status} {_reason(status)}\r\n"
            f"content-length: {len(text)}\r\nconnection: close\r\n\r\n".encode() + text)
        await self.writer.drain()


def _reason(status: int) -> str:
    return {200: "OK", 201: "Created", 204: "No Content", 206: "Partial Content",
            301: "Moved Permanently", 304: "Not Modified", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
            413: "Payload Too Large", 416: "Range Not Satisfiable",
            422: "Unprocessable Entity", 431: "Headers Too Large",
            500: "Internal Server Error"}.get(status, "Unknown")


class AsgiServer:
    def __init__(self, app, host: str = "0.0.0.0", port: int = 8080):
        self.app = app
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None

    async def _client(self, reader, writer):
        await _Connection(self.app, reader, writer).handle()

    async def startup(self) -> None:
        await self._run_lifespan("startup")
        self._server = await asyncio.start_server(self._client, self.host, self.port)
        log.info("listening", extra={"host": self.host, "port": self.port})

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self._run_lifespan("shutdown")

    async def serve_forever(self) -> None:
        await self.startup()
        try:
            await self._server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await self.shutdown()

    async def _run_lifespan(self, phase: str) -> None:
        # One lifespan connection for the whole server lifetime: startup opens it,
        # shutdown reuses the same receive/send queues and awaits app exit.
        if phase == "startup":
            self._ls_to_app: asyncio.Queue = asyncio.Queue()
            self._ls_from_app: asyncio.Queue = asyncio.Queue()

            async def receive():
                return await self._ls_to_app.get()

            async def send(message):
                await self._ls_from_app.put(message)

            scope = {"type": "lifespan", "asgi": {"version": "3.0"}}
            self._ls_task = asyncio.create_task(self.app(scope, receive, send))
        await self._ls_to_app.put({"type": f"lifespan.{phase}"})
        message = await self._ls_from_app.get()
        if message["type"].endswith(".failed"):
            raise RuntimeError(f"lifespan {phase} failed: {message.get('message')}")
        if phase == "shutdown":
            await self._ls_task


def run(app, host: str = "0.0.0.0", port: int = 8080) -> None:
    asyncio.run(AsgiServer(app, host, port).serve_forever())
