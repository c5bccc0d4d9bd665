"""Synchronous test client for ASGI apps (framework parity with FastAPI's
TestClient, used pervasively by the reference's API tests,
backend/tests/test_api.py:14-60).

Copy of eioku_tpu/web/testing.py for the PyTorch port.

Wraps httpx.AsyncClient + ASGITransport and drives a private event loop, also
emitting lifespan startup/shutdown around the client's lifetime.
"""
from __future__ import annotations

import asyncio
from typing import Any

import httpx


class TestClient:
    __test__ = False  # keep pytest from collecting this as a test class

    def __init__(self, app, base_url: str = "http://testserver",
                 run_lifespan: bool = True):
        self.app = app
        self.base_url = base_url
        self.run_lifespan = run_lifespan
        self._loop = asyncio.new_event_loop()
        self._client: httpx.AsyncClient | None = None
        self._ls_to_app: asyncio.Queue | None = None
        self._ls_task = None

    # -- lifecycle ---------------------------------------------------------------

    def __enter__(self) -> "TestClient":
        transport = httpx.ASGITransport(app=self.app)
        self._client = httpx.AsyncClient(transport=transport, base_url=self.base_url)
        if self.run_lifespan:
            self._loop.run_until_complete(self._startup())
        return self

    def __exit__(self, *exc) -> None:
        if self.run_lifespan and self._ls_task is not None:
            self._loop.run_until_complete(self._shutdown())
        self._loop.run_until_complete(self._client.aclose())
        self._loop.close()

    async def _startup(self) -> None:
        self._ls_to_app = asyncio.Queue()
        self._ls_from_app: asyncio.Queue = asyncio.Queue()

        async def receive():
            return await self._ls_to_app.get()

        async def send(message):
            await self._ls_from_app.put(message)

        self._ls_task = asyncio.ensure_future(
            self.app({"type": "lifespan", "asgi": {"version": "3.0"}}, receive, send))
        await self._ls_to_app.put({"type": "lifespan.startup"})
        message = await self._ls_from_app.get()
        if message["type"].endswith(".failed"):
            raise RuntimeError(f"startup failed: {message.get('message')}")

    async def _shutdown(self) -> None:
        await self._ls_to_app.put({"type": "lifespan.shutdown"})
        await self._ls_from_app.get()
        await self._ls_task

    # -- requests ------------------------------------------------------------------

    def request(self, method: str, url: str, **kw: Any) -> httpx.Response:
        return self._loop.run_until_complete(self._client.request(method, url, **kw))

    def get(self, url: str, **kw: Any) -> httpx.Response:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw: Any) -> httpx.Response:
        return self.request("POST", url, **kw)

    def put(self, url: str, **kw: Any) -> httpx.Response:
        return self.request("PUT", url, **kw)

    def delete(self, url: str, **kw: Any) -> httpx.Response:
        return self.request("DELETE", url, **kw)

    def patch(self, url: str, **kw: Any) -> httpx.Response:
        return self.request("PATCH", url, **kw)
