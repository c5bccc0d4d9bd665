"""In-process metrics: counters + latency histograms + stage timers.

Copy of eioku_tpu/utils/metrics.py for the PyTorch port.

The reference has no metrics/tracing at all — observability is JSON logs only
(SURVEY.md section 5). This framework treats per-stage timing as first-class:
the task handler and engine record stage durations here, the API exposes a
snapshot at /api/v1/metrics, and profiler traces can be captured via
EIOKU_PROFILE_DIR (torch.profiler, host and CUDA activity) around any task
execution.
"""
from __future__ import annotations

import math
import os
import re
import threading
import time
from contextlib import contextmanager

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


METRICS = MetricsRegistry()


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
    Chrome trace that chrome://tracing and Perfetto open."""
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
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
