"""In-process metrics: counters, latency histograms, stage timers, and the
spans and counters of the port's own tasks.

Copy of eioku_tpu/utils/metrics.py for the PyTorch port, with tracing.

The reference has no metrics/tracing at all — observability is JSON logs only
(SURVEY.md section 5). Who records what:
- the task handler (`workers/task_handler.py`): `task_seconds`,
  `tasks_completed`, `tasks_failed`, `artifacts_created`, by task type, in
  the registry (`MetricsRegistry`, as in the JAX package);
- the engine (`ml/engine.py` `run_task`) opens each task's root span,
  `task`, and the paths under it open their own spans and count their
  work (`METRICS.span`, `METRICS.count`; transcription's are listed in
  README.md): when the root closes, the task's totals per span name (calls,
  ns, self ns) and its counters go into a bounded buffer of recent tasks,
  `METRICS.recent_tasks()`, in the process that ran the task.
The API exposes the registry of its own process at /api/v1/metrics (JSON or
Prometheus). `maybe_profile` (EIOKU_PROFILE_DIR) captures a torch.profiler
trace (host and CUDA activity) around a task's execution, and appends the
block's program spans to it on a track of their own.

A span's clock is `time.perf_counter_ns()` (CLOCK_MONOTONIC). Spans nest
through a context variable, which `asyncio.to_thread` copies into its
worker thread; outside a task, `span` and `count` do nothing. A span adds
no device synchronisation and no profiler range: on the card its time is
the host's, which waits for the device only where the code it encloses
does.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import math
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

_BUCKETS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500]


class _Histogram:
    __slots__ = ("counts", "total", "count", "min", "max")

    def __init__(self):
        self.counts = [0] * (len(_BUCKETS) + 1)
        self.total = 0.0
        self.count = 0
        self.min = math.inf
        self.max = 0.0

    def observe(self, v: float) -> None:
        i = 0
        while i < len(_BUCKETS) and v > _BUCKETS[i]:
            i += 1
        self.counts[i] += 1
        self.total += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.min if self.count else 0.0,
            "max": self.max,
            "buckets": {**{f"le_{b}": c
                           for b, c in zip(_BUCKETS, self.counts)},
                        "le_inf": self.counts[-1]},  # overflow bucket
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._histograms: dict[str, _Histogram] = {}

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def observe(self, name: str, seconds: float, **labels) -> None:
        key = _key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = _Histogram()
            h.observe(seconds)

    @contextmanager
    def timer(self, name: str, **labels):
        start = time.monotonic()
        try:
            yield
        finally:
            self.observe(name, time.monotonic() - start, **labels)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "timings": {k: h.snapshot() for k, h in self._histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._histograms.clear()


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    lab = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{lab}}}"


# the innermost open span of this context
_OPEN_SPAN: contextvars.ContextVar = contextvars.ContextVar("eioku_open_span", default=None)
# while maybe_profile's block runs: the list that keeps each span's interval
_KEPT_SPANS: contextvars.ContextVar = contextvars.ContextVar("eioku_kept_spans", default=None)
_NO_SPAN = nullcontext()
RECENT_TASKS = 256  # task records the registry keeps
_SPAN_TRACK = 1 << 30  # a merged trace's span track: this plus the thread id (< 2**22)


class _Task:
    """An open task: its totals per span name ([calls, ns, self ns]) and its
    counters, written only by the context that runs it."""

    __slots__ = ("registry", "id", "type", "spans", "counters")

    def __init__(self, registry: "TaskMetrics", task_id: int, task_type: str):
        self.registry, self.id, self.type = registry, task_id, task_type
        self.spans: dict[str, list[int]] = {}
        self.counters: dict[str, float] = {}


class _Span:
    """One span of a task, a context manager; its parent is the span that
    was open where it opened (None for the task's root)."""

    __slots__ = ("name", "task", "parent", "start_ns", "child_ns", "_token")

    def __init__(self, name: str, task: _Task, parent: "_Span | None"):
        self.name, self.task, self.parent = name, task, parent
        self.child_ns = 0

    def __enter__(self) -> "_Span":
        self._token = _OPEN_SPAN.set(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = time.perf_counter_ns()
        _OPEN_SPAN.reset(self._token)
        took = end - self.start_ns
        totals = self.task.spans.get(self.name)
        if totals is None:
            totals = self.task.spans[self.name] = [0, 0, 0]
        totals[0] += 1
        totals[1] += took
        totals[2] += took - self.child_ns
        kept = _KEPT_SPANS.get()
        if kept is not None:
            kept.append((self.name, self.start_ns, end, self.task.id, self.task.type,
                         self.parent.name if self.parent is not None else None,
                         threading.get_native_id()))
        if self.parent is not None:
            self.parent.child_ns += took
        else:
            self.task.registry._close_task(self.task, self.start_ns, end, exc_type is None)


class TaskMetrics(MetricsRegistry):
    """The registry with the spans and counters of the port's tasks: each
    task's record goes into a bounded buffer of recent tasks when its root
    span closes."""

    def __init__(self):
        super().__init__()
        self._tasks: deque[dict] = deque(maxlen=RECENT_TASKS)
        self._task_ids = itertools.count(1)

    def task(self, task_type: str) -> _Span:
        """The root span, `task`, of a new task with an id of its own; the
        spans and counts inside it are the task's."""
        return _Span("task", _Task(self, next(self._task_ids), task_type), None)

    def span(self, name: str):
        """A span `name` under the innermost open span of this context (a
        context manager), or nothing outside a task."""
        parent = _OPEN_SPAN.get()
        if parent is None:
            return _NO_SPAN
        return _Span(name, parent.task, parent)

    def count(self, name: str, n: float = 1) -> None:
        """Add n to the open task's counter `name` (nothing outside a task)."""
        span = _OPEN_SPAN.get()
        if span is not None:
            counters = span.task.counters
            counters[name] = counters.get(name, 0) + n

    def _close_task(self, task: _Task, start_ns: int, end_ns: int, ok: bool) -> None:
        spans = {name: {"count": c, "total_ns": t, "self_ns": s}
                 for name, (c, t, s) in task.spans.items()}
        record = {"id": task.id, "type": task.type, "start_ns": start_ns, "end_ns": end_ns,
                  "ok": ok, "spans": spans, "counters": dict(task.counters)}
        with self._lock:
            self._tasks.append(record)

    def recent_tasks(self) -> list[dict]:
        """The records of the last RECENT_TASKS tasks to close, oldest first:
        id, type, start_ns and end_ns (perf_counter_ns), ok, per span name
        its count, total_ns and self_ns (less its child spans), counters."""
        with self._lock:
            return list(self._tasks)

    def reset(self) -> None:
        super().reset()
        with self._lock:
            self._tasks.clear()


METRICS = TaskMetrics()


# pairs split on commas that START a new `key=` (label VALUES may contain
# commas — _key joins with plain ','/'=' so the split must be lookahead-aware)
_LABEL_SPLIT = re.compile(r",(?=[A-Za-z_][A-Za-z0-9_]*=)")


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _prom_name(key: str) -> tuple[str, str]:
    """Split an internal 'name{k=v,...}' key into (sanitized metric name,
    label string with quoted, escaped values)."""
    name, labels = key, ""
    if "{" in key:
        name, rest = key.split("{", 1)
        pairs = [p.split("=", 1) for p in _LABEL_SPLIT.split(rest.rstrip("}"))
                 if "=" in p]
        labels = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in pairs)
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return name, labels


def to_prometheus(snap: dict) -> str:
    """Render a MetricsRegistry snapshot (+optional 'queue' counts) in the
    Prometheus text exposition format: counters verbatim, timing histograms
    as _count/_sum/_bucket with CUMULATIVE le buckets (ours are per-bucket).
    One TYPE line per metric NAME (the format forbids repeating it per
    labeled child). Served by /api/v1/metrics?format=prometheus."""
    lines: list[str] = []
    typed: set[str] = set()

    def type_line(full_name: str, kind: str) -> None:
        if full_name not in typed:
            typed.add(full_name)
            lines.append(f"# TYPE {full_name} {kind}")

    for key, value in sorted(snap.get("counters", {}).items()):
        name, labels = _prom_name(key)
        type_line(f"eioku_{name}", "counter")
        lines.append(f"eioku_{name}{{{labels}}} {value}" if labels
                     else f"eioku_{name} {value}")
    for key, h in sorted(snap.get("timings", {}).items()):
        name, labels = _prom_name(key)
        base = f"eioku_{name}_seconds"
        pre = labels + "," if labels else ""
        type_line(base, "histogram")
        cum = 0
        for b, c in zip(_BUCKETS, list(h["buckets"].values())[:-1]):
            cum += c
            lines.append(f'{base}_bucket{{{pre}le="{b}"}} {cum}')
        lines.append(f'{base}_bucket{{{pre}le="+Inf"}} {h["count"]}')
        lines.append(f"{base}_sum{{{labels}}} {h['mean'] * h['count']:.6f}"
                     if labels else f"{base}_sum {h['mean'] * h['count']:.6f}")
        lines.append(f"{base}_count{{{labels}}} {h['count']}" if labels
                     else f"{base}_count {h['count']}")
    if snap.get("queue"):
        type_line("eioku_queue_jobs", "gauge")
        for status, n in sorted(snap["queue"].items()):
            lines.append(f'eioku_queue_jobs{{status="{status}"}} {n}')
    return "\n".join(lines) + "\n"


@contextmanager
def maybe_profile(tag: str):
    """Capture a torch.profiler trace for this block when EIOKU_PROFILE_DIR is
    set. Host ops of every thread, plus CUDA kernels and copies where the
    host has a card, land in $EIOKU_PROFILE_DIR/<tag>-<ts>/trace.json, a
    Chrome trace that chrome://tracing and Perfetto open. The program's
    spans of the block (`METRICS.span`) are appended to it as complete
    events on a track of their own per thread, on the trace's clock, so
    that each idle gap of the card shows under the span that was open; a
    profiler started elsewhere sees none of them. A whole long task makes a
    trace of hundreds of MB that torch takes minutes to export: profile
    short tasks."""
    profile_dir = os.environ.get("EIOKU_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch

    path = os.path.join(profile_dir, f"{tag}-{int(time.time())}")
    os.makedirs(path, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # the engine runs in asyncio.to_thread's worker thread: without
    # profile_all_threads the trace holds only this thread's (idle) ops
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    kept: list[tuple] = []
    token = _KEPT_SPANS.set(kept)
    prof.start()
    # the profiler's clock is the Unix time; the spans' is perf_counter_ns
    unix_less_perf_ns = time.time_ns() - time.perf_counter_ns()
    try:
        yield
    finally:
        prof.stop()
        _KEPT_SPANS.reset(token)
        trace = os.path.join(path, "trace.json")
        prof.export_chrome_trace(trace)
        merge_spans(trace, kept, unix_less_perf_ns)


def merge_spans(trace_path: str, spans: list[tuple], unix_less_perf_ns: int) -> None:
    """Append kept spans (name, start ns, end ns, task id, task type, parent
    name, thread id) to a torch.profiler Chrome trace as "X" events in its
    time base (microseconds after `baseTimeNanoseconds`, in Unix time), one
    named track per thread of this process. The events go in where the
    trace's `traceEvents` array closes, in place: only the file's head and
    tail are read, whatever the trace's size."""
    if not spans:
        return
    pid = os.getpid()
    with open(trace_path, "r+b") as f:
        base = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read(1 << 16))
        base_ns = int(base.group(1)) if base else 0
        size = f.seek(0, os.SEEK_END)
        at = max(0, size - (1 << 16))
        f.seek(at)
        tail = f.read()
        close = _events_close(tail)
        if close is None:
            raise ValueError(f"{trace_path}: no traceEvents array closes its trace")
        events = []
        for name, start, end, task_id, task_type, parent, thread in spans:
            events.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid,
                           "tid": _SPAN_TRACK + thread,  # beside the thread's own track
                           "ts": (start + unix_less_perf_ns - base_ns) / 1e3,
                           "dur": (end - start) / 1e3,
                           "args": {"task_id": task_id, "task_type": task_type,
                                    "parent": parent}})
        for thread in sorted({span[6] for span in spans}):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": _SPAN_TRACK + thread,
                           "args": {"name": f"program spans, thread {thread}"}})
        lead = b"" if tail[:close].rstrip().endswith(b"[") else b","
        f.seek(at + close)
        f.write(lead + ",".join(map(json.dumps, events)).encode() + tail[close:])


def _events_close(tail: bytes) -> int | None:
    """The offset in a Chrome trace's tail of the `]` that closes its
    `traceEvents` array: the last `]` after which only the object's
    remaining members follow."""
    close = tail.rfind(b"]")
    while close >= 0:
        try:
            if isinstance(json.loads(b'{"traceEvents": []' + tail[close + 1:]), dict):
                return close
        except ValueError:
            pass
        close = tail.rfind(b"]", 0, close)
    return None
