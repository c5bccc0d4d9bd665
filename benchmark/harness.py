"""What every cell of the benchmark shares: where the files and caches are,
the cell's lookup by name, the card check, spans from wrappers, the
profiler's reduction, the statistics and the result line.

The benchmark measures the PyTorch/CUDA port (`eioku_tpu_torch`) only. No
file here imports JAX or the JAX package; `forbidden_modules` checks the
process once the window has closed.
"""
from __future__ import annotations

import heapq
import importlib.util
import json
import math
import os
import sys
import time
from collections import defaultdict

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# caches of fixed paths inside the checkout (the root .gitignore lists it):
# seeded inputs, and the kernel caches, so that only a cell's first run in a
# checkout builds and compiles
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")

FORBIDDEN = ("jax", "jaxlib", "flax", "eioku_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot, against the boot-time clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def set_cache_env() -> None:
    """Point the kernel caches at fixed directories inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = os.path.join(CACHE_DIR, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the cell, by name --------------------------------------------------------------


class Cell:
    """One entry of BENCHMARK.json's `workloads`, with its configuration file,
    its traffic file and the metrics it reports."""

    def __init__(self, spec: dict, name: str):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise LookupError(f"unknown workload {name!r}; known: {sorted(by_name)}")
        self.workload = by_name[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _read_json(os.path.join(ROOT, self.config_entry["file"]))
        traffic_path = os.path.join(BENCH_DIR, "traffic", self.workload["traffic"] + ".json")
        if not os.path.isfile(traffic_path):
            raise LookupError(f"no traffic file {traffic_path}")
        self.traffic = _read_json(traffic_path)
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if _applies(m, name)]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(add: str | None = None) -> dict:
    """BENCHMARK.json, with the entries of the fragment file `add` appended
    (a cell kept out of the benchmark, run only by hand)."""
    spec = _read_json(os.path.join(ROOT, "BENCHMARK.json"))
    if add:
        for key, entries in _read_json(add).items():
            spec[key] = spec[key] + entries
    return spec


def metric_reader(name: str):
    """The `read(readings)` function of benchmark/metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise LookupError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_layers(cell: Cell, readings: dict) -> dict:
    """Each of the cell's per-layer metrics that its reader finds something
    to read for."""
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(readings)
        if v is not None:
            out[m["name"]] = v
    return out


def unit_of(cell: Cell, name: str) -> str:
    return next(m["unit"] for m in cell.end_to_end + cell.per_layer if m["name"] == name)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole (the port's name starts with the JAX
    package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# -- statistics ----------------------------------------------------------------------


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank, over all values; a
    missing value (None: a failed or unanswered request) counts as infinitely
    late."""
    xs = sorted(math.inf if v is None else v for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[rank - 1]


def span_median_ms(spans: list | None) -> float | None:
    """The median duration of [(start s, end s)] spans, in ms (the lower
    middle one of an even count), or None without spans."""
    if not spans:
        return None
    d = sorted(t1 - t0 for t0, t1 in spans)
    return d[(len(d) - 1) // 2] * 1e3


# -- spans -----------------------------------------------------------------------------


class Spans:
    """Host-clock spans recorded by wrappers the benchmark puts around the
    port's module functions. With `sync` each span synchronises the card at
    both ends, so it covers the device work it launched (traced runs only)."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.records: dict[str, list[tuple[float, float, dict]]] = defaultdict(list)
        self.counters: dict[str, float] = defaultdict(float)
        self._restore: list[tuple[object, str, object]] = []

    def _sync(self) -> None:
        if self.sync:
            import torch
            torch.cuda.synchronize()

    def patch(self, owner, attr: str, new) -> None:
        """Set owner.attr to `new` until `restore`."""
        self._restore.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def wrap(self, owner, attr: str, name: str, meta=None, annotate: bool = True) -> None:
        """Replace owner.attr by a wrapper that records a span `name` per
        call; meta(args, kwargs, out) adds fields to the record."""
        fn = getattr(owner, attr)
        spans = self

        def wrapped(*args, **kwargs):
            spans._sync()
            t0 = time.perf_counter()
            if annotate and spans.sync:
                import torch
                with torch.profiler.record_function("bench:" + name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            spans._sync()
            t1 = time.perf_counter()
            spans.records[name].append((t0, t1, meta(args, kwargs, out) if meta else {}))
            return out
        self.patch(owner, attr, wrapped)

    def total(self, name: str) -> float:
        return sum(t1 - t0 for t0, t1, _ in self.records.get(name, ()))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._restore):
            setattr(owner, attr, fn)
        self._restore.clear()


# -- the profiler's slice ----------------------------------------------------------------


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost_labels(points: list[float], events: list[tuple[str, float, float]]) -> list[str]:
    """For each point (ascending), the name of the shortest event that spans
    it, or ''."""
    events = sorted(events, key=lambda e: e[1])
    heap: list[tuple[float, float, str]] = []
    out, i = [], 0
    for p in points:
        while i < len(events) and events[i][1] <= p:
            name, s, e = events[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "")
    return out


def profile_summary(prof, wall_s: float, top: int = 10) -> dict:
    """Reduce a torch.profiler slice: device busy seconds (the union of the
    kernels' intervals), the slice's wall seconds, device seconds by kernel
    name (`kernels`: all, with their `calls`; `device_ops`: the top ones),
    and the idle gaps
    between kernels summed by what the host was doing at each gap's middle
    (the innermost benchmark span, then the innermost PyTorch operation)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, annotations, ops = [], [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("bench:"):
            # a benchmark span; the profiler also puts its range on the
            # device's timeline, which is no kernel
            if e.device_type != cuda:
                annotations.append((e.name[len("bench:"):], s, t))
        elif e.device_type == cuda:
            kernels.append((e.name, s, t))
        elif not e.name.startswith(("cuda", "ProfilerStep")):
            ops.append((e.name, s, t))
    by_name: dict[str, float] = defaultdict(float)
    calls: dict[str, int] = defaultdict(int)
    for name, s, t in kernels:
        by_name[name] += (t - s) / 1e6
        calls[name] += 1
    merged = _union([(s, t) for _, s, t in kernels])
    busy_s = sum(t - s for s, t in merged) / 1e6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    mids = [(a + b) / 2 for a, b in gaps]
    outer = _innermost_labels(mids, annotations)
    inner = _innermost_labels(mids, ops)
    idle: dict[str, float] = defaultdict(float)
    for (a, b), o, n in zip(gaps, outer, inner):
        idle[" > ".join(x for x in (o, n) if x) or "no host span"] += (b - a) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": wall_s, "kernels": dict(ranked),
            "calls": dict(calls), "launches": len(kernels),
            "device_ops": [[n, s] for n, s in ranked[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


# -- the device and the result line --------------------------------------------------------


def require_cards(n: int) -> None:
    """Exit nonzero, printing no result, without CUDA or with fewer cards
    than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the port on an NVIDIA GPU only")
        sys.exit(3)
    if torch.cuda.device_count() < n:
        log(f"the cell needs {n} CUDA devices, {torch.cuda.device_count()} visible")
        sys.exit(3)


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card, or ''."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def host_line() -> str:
    """The host's load average and the card's SM clock: context for a
    window's wall times, which the host's other tenants move."""
    import subprocess

    with open("/proc/loadavg") as f:
        load = " ".join(f.read().split()[:3])
    try:
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        clocks = "?"
    return f"load average {load}; card clocks, max, power: {clocks}"


def host_counters() -> dict:
    """Cumulative host readings whose change over a window tells what held
    the process back: `cpu_s`, this process's CPU time (about the wall when
    one thread launches and waits); `steal_s`, the time the hypervisor gave
    this machine's CPUs to others, all CPUs summed (0 where the machine
    does not report it)."""
    with open("/proc/stat") as f:
        fields = f.readline().split()
    return {"cpu_s": sum(os.times()[:2]),
            "steal_s": int(fields[8]) / os.sysconf("SC_CLK_TCK") if len(fields) > 8 else 0.0}


def host_delta(before: dict, after: dict) -> str:
    return ", ".join(f"{k} {after[k] - before[k]:.3f}" for k in before)


def result_line(cell: Cell, checks: dict, attempted: int, failed: int, metrics: dict,
                device: dict, profile: dict | None) -> dict:
    """The result's keys: `correct` (every compared number within its
    limit), the counts, each metric with its unit, the device (with the
    profiler slice's busy and window seconds) and, traced, the breakdown."""
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": attempted, "failed": failed,
           "metrics": {k: {"value": v, "unit": unit_of(cell, k)} for k, v in metrics.items()},
           "device": dict(device)}
    if profile is not None:
        out["device"].update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    return out


def emit(result: dict, checks: dict[str, tuple[float, float]]) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result line (checks last) on standard output."""
    found = forbidden_modules()
    if found:
        log(f"refusing to report: the process loaded {found}")
        sys.exit(4)
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
