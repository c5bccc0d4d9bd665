"""Task progress reporting (copy of eioku_tpu/utils/progress.py; host-only).

ML pipelines call `report(frac)` at chunk boundaries (frames decoded,
transcription windows finished, ...); the task handler installs a throttled
sink around each engine dispatch that persists the fraction onto the task row,
where it flows out through /api/v1/tasks and the /tasks/stream SSE feed.

The sink travels in a ContextVar: `asyncio.to_thread` copies the caller's
context, so a reporter installed in the async task handler is visible inside
the engine's worker thread without threading a callback through every
pipeline signature. Pipelines stay decoupled — with no sink installed,
`report()` is a no-op (bench.py and unit tests run the same code paths
without a database).

The upstream Eioku backend has no analog: its task rows expose only status
and timestamps, and its SPA shows status chips. Long-running jobs (a feature-length transcription is minutes
even on TPU) deserve a live fraction.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Iterator

_SINK: ContextVar[Callable[[float], None] | None] = ContextVar(
    "eioku_progress_sink", default=None)


def report(frac: float) -> None:
    """Report fractional completion of the current task (0.0 .. 1.0).

    Safe to call from any pipeline at any frequency: no-op when no sink is
    installed, clamps out-of-range values, and never lets a sink error kill
    the work it is narrating.
    """
    sink = _SINK.get()
    if sink is None:
        return
    if frac != frac:  # NaN guard (0/0 totals)
        return
    try:
        sink(min(max(float(frac), 0.0), 1.0))
    except Exception:  # pragma: no cover - sink bugs must not fail the task
        pass


@contextmanager
def reporting(sink: Callable[[float], None]) -> Iterator[None]:
    """Install `sink` as the progress destination for the enclosed work."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def throttled(write: Callable[[float], None], *, min_interval_s: float = 1.0,
              min_delta: float = 0.01) -> Callable[[float], None]:
    """Wrap a persistence function so mid-run writes are rate-limited.

    A decode loop can report thousands of times; the database should see a
    write at most every `min_interval_s` seconds and only when the fraction
    moved by `min_delta`. frac >= 1.0 always writes (terminal update).
    """
    import time

    # t=None: the FIRST write always lands — seeding with 0.0 would silently
    # drop it whenever the process starts within min_interval_s of boot
    # (time.monotonic() counts from boot on Linux)
    state = {"t": None, "frac": -1.0, "terminal": False}

    def sink(frac: float) -> None:
        now = time.monotonic()
        if frac >= 1.0:
            # terminal update bypasses both gates, but only ONCE: a pipeline
            # whose clamped fraction hits 1.0 mid-run (metadata duration
            # shorter than the real stream) must not turn every remaining
            # batch into an unthrottled DB write
            if state["terminal"]:
                return
            state["terminal"] = True
        elif state["t"] is not None and (
                now - state["t"] < min_interval_s
                or frac - state["frac"] < min_delta):
            return
        state["t"] = now
        state["frac"] = frac
        write(frac)

    return sink
