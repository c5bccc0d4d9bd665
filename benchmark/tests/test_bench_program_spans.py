"""The metrics that read the port's own spans and counters, on a traced
rehearsal of the transcription cell on the CPU: reported, read from the
window's jobs alone, and consistent with the benchmark's wrappers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, program_tasks
from benchmark.drivers import jobs

PROGRAM_METRICS = ("decode_forward_ms_per_step", "decode_select_ms_per_step",
                   "decode_sync_ms_per_step", "task_self_ms_per_job", "padded_slots_pct")
SEED = 2_900_000_023


def test_run_py_reports_the_program_metrics():
    """`run.py --rehearse --trace 1`, as a process of its own (this one has
    loaded JAX through the root conftest, which the result line refuses)."""
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload",
         "large-v3.transcribe", "--seed", str(SEED), "--seconds", "1", "--trace", "1",
         "--rehearse"], capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    for name in PROGRAM_METRICS:
        assert isinstance(result["metrics"][name]["value"], float), name
    assert 0 < result["metrics"]["padded_slots_pct"]["value"] < 100


@pytest.fixture(scope="module")
def traced():
    """One traced rehearsal in this process: (its result, the readings the
    per-layer readers got, the program's task records of the run)."""
    from eioku_tpu_torch.utils.metrics import METRICS

    seen = {}
    read_layers = harness.read_layers

    def keep(cell, readings):
        seen["r"] = readings
        return read_layers(cell, readings)
    before = {t["id"] for t in METRICS.recent_tasks()}
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "read_layers", keep)
    try:
        cell = harness.Cell(harness.load_spec(), "large-v3.transcribe")
        result, _ = jobs.run(cell, SEED, 1.0, trace=True, rehearse=True)
    finally:
        mp.undo()
    mine = [t for t in METRICS.recent_tasks() if t["id"] not in before]
    return result, seen["r"], mine


def test_the_window_jobs_alone_are_read(traced):
    from eioku_tpu_torch.utils.metrics import METRICS

    _, r, mine = traced
    tasks = program_tasks.window_tasks(r)
    assert len(tasks) == r["jobs"] >= 1
    # the run's first task is the warm-up job, outside the window
    assert len(mine) == r["jobs"] + 1
    assert [t["id"] for t in tasks] == [t["id"] for t in mine[1:]]
    with METRICS.task("transcription"):  # a later job, as the profiler slice's
        pass
    assert [t["id"] for t in program_tasks.window_tasks(r)] == [t["id"] for t in tasks]


def test_the_program_counts_agree_with_the_wrappers(traced):
    result, r, _ = traced
    tasks = program_tasks.window_tasks(r)
    assert program_tasks.counted(tasks, "decode_steps") == r["counters"]["decode_steps"] > 0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    parts = m["decode_forward_ms_per_step"] + m["decode_select_ms_per_step"] + \
        m["decode_sync_ms_per_step"]
    assert parts <= m["decode_ms_per_step"]
    # the task's self time is a part of what the wrappers leave to the task
    assert 0 <= m["task_self_ms_per_job"] <= m["task_host_ms_per_job"]


def test_an_older_port_reads_as_nothing(traced, monkeypatch):
    from eioku_tpu_torch.utils import metrics

    _, r, _ = traced
    monkeypatch.setattr(metrics, "METRICS", object())  # no records of its own
    for name in PROGRAM_METRICS:
        assert harness.metric_reader(name)(r) is None, name
