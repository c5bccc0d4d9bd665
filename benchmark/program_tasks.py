"""The program's own task records, for the readers of the metrics that read
the port's spans and counters.

`eioku_tpu_torch.utils.metrics.METRICS.recent_tasks()` holds, for each
recent `InferenceEngine.run_task`, its interval on `perf_counter_ns`, its
totals per span name (calls, ns, self ns) and its counters. The window's
jobs are the records whose interval holds one of the window's own records
in `r["spans"]` (the same clock, in seconds): the warm-up job and the
profiler slice's job fall outside. A program without such records (an
older port) reads as nothing.
"""
from __future__ import annotations


def window_tasks(r) -> list[dict] | None:
    """The window's task records, or None unless there is one per job."""
    if not r.get("jobs"):
        return None
    from eioku_tpu_torch.utils import metrics

    recent = getattr(metrics.METRICS, "recent_tasks", None)
    if recent is None:
        return None
    marks = [(t0, t1) for recs in r["spans"].records.values() for t0, t1, _ in recs]
    tasks = [t for t in recent()
             if any(t["start_ns"] / 1e9 <= t0 and t1 <= t["end_ns"] / 1e9 for t0, t1 in marks)]
    return tasks if len(tasks) == r["jobs"] else None


def total(tasks: list[dict], span: str, key: str = "total_ns") -> int | None:
    """A span name's `total_ns` (or `self_ns`) over the tasks, or None where
    no task opened it."""
    found = [t["spans"][span][key] for t in tasks if span in t["spans"]]
    return sum(found) if found else None


def counted(tasks: list[dict], counter: str) -> float:
    return sum(t["counters"].get(counter, 0) for t in tasks)


def ms_per_step(r, span: str) -> float | None:
    """A decoder span's total over the window's decoder steps (prefill
    steps included, as `decode_steps` counts them), in ms."""
    tasks = window_tasks(r)
    if tasks is None:
        return None
    ns, steps = total(tasks, span), counted(tasks, "decode_steps")
    if ns is None or not steps:
        return None
    return ns / steps / 1e6
