"""A closed loop of jobs on one worker, one job after another, for any model
that the port runs as a task: the part of a job driver that is not the
model's.

A driver of this kind is a module `drivers/<name>.py` that hands itself to
`run` and `calibrate` and provides the model's part:

- `RATE`: the end-to-end metric that the window yields, the amount of the
  completed jobs over the whole window (its unit in BENCHMARK.json is the
  amount's unit over `/s`);
- `CHECKED`: the readings compared against the configuration's `limits`;
  `COMPARED`: the reading that counts what was compared (none of it: the
  run is not correct);
- `write_jobs(folder, seed, traffic)`: (the warm-up job's path,
  [(path, amount)] of the window's jobs), the same work for every seed;
- `Port(model_cfg, device, cache)`: the port's entry, with `device`,
  `give(seed)` (the seed's weights for the next load), `run(path)`,
  `forget()` and `close()`;
- `install_capture(spans, port, seed, traffic)`: wrappers that keep what a
  seeded reservoir of the window's own outputs needs for the check (a
  `Reservoir`, which the loop switches on for the window);
- `trace_wrappers(spans, traffic, model_cfg)`: the traced run's spans and
  counters, and the profiler's slice, armed by the returned state
  (`armed`; `done` holds the stopped profiler, `slice_s` its wall, `what`
  says what it covers);
- `check(kept, model_cfg, seed, device, control=False)`: the readings from
  the plain reference, run on the kept outputs once the port is released
  (with `control`, the control's readings too, under "control");
- `layer_readings(model_cfg, done)`: what the model's per-layer readers
  read beside the loop's spans, counters, profile and window.

Set-up (imports, the jobs, the weights, the warm-up job that takes every
shape the window takes) ends at `setup_s`. The window runs whole passes
over the jobs in their order and closes at the end of the first pass that
ends after `--seconds`, so that every run does the same work.
"""
from __future__ import annotations

import gc
import os
import random
import time

from benchmark import harness


def settings(cell: harness.Cell, rehearse: bool) -> tuple[dict, dict]:
    """The cell's configuration and traffic, with their `rehearse` sizes
    laid over them in a rehearsal (the job's settings merged key by key)."""
    model_cfg, traffic = dict(cell.config), dict(cell.traffic)
    if rehearse:
        small = model_cfg["rehearse"]
        model_cfg.update(small)
        model_cfg["job"] = {**cell.config["job"], **small.get("job", {})}
        traffic.update(traffic["rehearse"])
    return model_cfg, traffic


def _sync(device: str) -> None:
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def window(port, jobs, seconds: float) -> tuple[float, list[tuple[float, float]]]:
    """Whole passes over the jobs, in order, until the first pass that ends
    after `seconds`: every run does the same work, whatever the host's
    speed (a window cut at any job boundary holds more or fewer jobs on a
    faster or slower host, and the jobs' amounts per batch differ).
    Returns (elapsed s, [(amount, job wall s)])."""
    done = []
    _sync(port.device)
    t0 = time.perf_counter()
    while not done or len(done) % len(jobs) or time.perf_counter() - t0 < seconds:
        path, amount = jobs[len(done) % len(jobs)]
        t = time.perf_counter()
        port.run(path)
        done.append((amount, time.perf_counter() - t))
    _sync(port.device)
    return time.perf_counter() - t0, done


class Reservoir:
    """A seeded reservoir of `keep` of the records offered while `on`: the
    window's outputs that the check compares. It keeps references only: no
    copy and no synchronisation on the timed path."""

    def __init__(self, seed: int, keep: int):
        self.rng = random.Random(seed)
        self.keep = keep
        self.seen = 0
        self.kept: list[dict] = []
        self.on = False

    def offer(self, rec: dict) -> None:
        self.seen += 1
        if len(self.kept) < self.keep:
            self.kept.append(rec)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.keep:
                self.kept[j] = rec

    def describe(self) -> str:
        """A line on what the window produced, for the run's log."""
        return f"outputs: {self.seen} offered to the check, {len(self.kept)} kept"


def run(m, cell: harness.Cell, seed: int, seconds: float, trace: bool,
        rehearse: bool) -> tuple[dict, dict]:
    """One run of a cell of the model module `m`: (result, checks)."""
    import torch

    model_cfg, traffic = settings(cell, rehearse)
    device = "cpu" if rehearse else "cuda"
    folder = os.path.join(harness.CACHE_DIR, cell.name)
    port = m.Port(model_cfg, device, os.path.join(folder, "models"))
    harness.log(f"set-up: the port imported at {harness.process_age_s():.2f} s; torch threads "
                f"{torch.get_num_threads()}, CPUs {len(os.sched_getaffinity(0))}")
    warm, jobs = m.write_jobs(os.path.join(folder, "jobs"), seed, traffic)
    harness.log(f"set-up: jobs written at {harness.process_age_s():.2f} s")
    port.give(seed)
    harness.log(f"set-up: weights made at {harness.process_age_s():.2f} s")
    spans = harness.Spans(sync=trace and device != "cpu")
    capture = m.install_capture(spans, port, seed, traffic)
    st = m.trace_wrappers(spans, traffic, model_cfg) if trace else None
    port.run(warm)  # loads the weights; every shape the window takes, built and warm
    harness.log(f"set-up: loaded and warmed up at {harness.process_age_s():.2f} s")
    spans.records.clear()
    spans.counters.clear()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = harness.process_age_s()
    harness.log(f"window opens: {harness.host_line()}")
    host0 = harness.host_counters()
    capture.on = True
    elapsed, done = window(port, jobs, seconds)
    capture.on = False
    harness.log(f"window closed: {harness.host_line()}; over the window: "
                f"{harness.host_delta(host0, harness.host_counters())}")
    harness.log(capture.describe())
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    window_spans = {k: list(v) for k, v in spans.records.items()}
    window_counters = dict(spans.counters)
    amount = sum(a for a, _ in done)
    harness.log(f"window: {len(done)} jobs, {amount:.1f} "
                f"{harness.unit_of(cell, m.RATE).removesuffix('/s')} in {elapsed:.3f} s (asked "
                f"{seconds} s, closed at the end of the first pass over the jobs after it); "
                f"job walls {[round(w, 3) for _, w in done]}")
    profile = None
    if st is not None and device != "cpu":
        st["armed"] = True
        port.run(warm)  # the profiler's slice, after the window
        if st["done"] is not None:
            profile = harness.profile_summary(st["done"], st["slice_s"])
            harness.log(f"profiler slice ({st['what']}): {st['slice_s']:.4f} s, "
                        f"{profile['launches']} kernels, device busy {profile['busy_s']:.4f} s")
    spans.restore()
    kept = capture.kept
    port.close()
    del port, capture
    gc.collect()
    t = time.perf_counter()
    r = m.check(kept, model_cfg, seed, device)
    counts = ", ".join(f"{k} {v}" for k, v in r.items() if k not in m.CHECKED)
    harness.log(f"check: {len(kept)} kept outputs drawn from the seed, {counts}; the reference "
                f"took {time.perf_counter() - t:.1f} s")
    limits = cell.config["limits"]
    checks = {k: (r[k], limits[k]) for k in m.CHECKED}
    checks["unchecked"] = (float(r[m.COMPARED] == 0), 0.0)  # something was compared
    if trace:
        spans.records.clear()
        spans.records.update(window_spans)
        metrics = harness.read_layers(cell, {
            "spans": spans, "counters": window_counters, "profile": profile,
            "window_s": elapsed, "jobs": len(done), "device": device,
            **m.layer_readings(model_cfg, done)})
    else:
        metrics = {m.RATE: amount / elapsed, "setup_s": setup_s}
    if rehearse:
        device = {"platform": "cpu", "kind": "rehearsal", "count": 0, "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    return harness.result_line(cell, checks, len(done), 0, metrics, device, profile), checks


def calibrate(m, cell: harness.Cell, seeds: list[int], seconds: float) -> list[dict]:
    """The program's readings and the control's (the reference one
    precision below in its place, on the same inputs and outputs) on each
    seed, with one set-up: per seed the weights are made and loaded and the
    window runs `seconds`."""
    import torch

    model_cfg, traffic = settings(cell, rehearse=False)
    folder = os.path.join(harness.CACHE_DIR, cell.name)
    port = m.Port(model_cfg, "cuda", os.path.join(folder, "models"))
    rows = []
    for seed in seeds:
        _, jobs = m.write_jobs(os.path.join(folder, "jobs"), seed, traffic)
        port.give(seed)
        spans = harness.Spans()
        capture = m.install_capture(spans, port, seed, traffic)
        capture.on = True
        elapsed, done = window(port, jobs, seconds)
        spans.restore()
        port.forget()
        r = m.check(capture.kept, model_cfg, seed, "cuda", control=True)
        del capture
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "job_walls": [round(w, 3) for _, w in done], "elapsed_s": elapsed,
               **r}
        harness.log(f"calibration {row}")
        rows.append(row)
    port.close()
    return rows
