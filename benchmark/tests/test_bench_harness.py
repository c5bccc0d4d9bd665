"""The harness on the CPU: the cell's files by name, the window's rate and
tail, the profiler's reduction, and what the benchmark may import.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import ast
import asyncio
import http.server
import json
import os
import threading
import time

import pytest

from benchmark import harness, run
from benchmark.drivers import http_search, jobs

PENDING = os.path.join(harness.BENCH_DIR, "pending", "minilm.search.json")
SPEC = harness.load_spec(PENDING)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_found_by_name(name):
    cell = harness.Cell(SPEC, name)
    assert os.path.isfile(os.path.join(harness.ROOT, cell.config_entry["file"]))
    driver = cell.traffic["driver"]
    assert os.path.isfile(os.path.join(harness.BENCH_DIR, "drivers", driver + ".py"))
    assert run._driver(cell).__name__ == f"benchmark.drivers.{driver}"
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_a_pending_cell_is_not_in_the_benchmark():
    bench = harness.load_spec()
    assert "minilm.search" not in {w["name"] for w in bench["workloads"]}
    assert "minilm.search" in {w["name"] for w in SPEC["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert {c["name"] for c in bench["configs"]} == used
    cells = {w["name"] for w in bench["workloads"]}
    for key in ("end_to_end", "per_layer"):
        for m in bench[key]:
            assert set(m.get("workloads", ())) <= cells


def test_unknown_cell_or_metric_is_refused(capsys):
    assert run.main(["--workload", "no.such.cell", "--seed", "1", "--seconds", "1"]) == 2
    assert "unknown workload" in capsys.readouterr().err
    with pytest.raises(LookupError):
        harness.metric_reader("no_such_metric")


def test_every_metric_reads_nothing_from_an_empty_run():
    empty = {"spans": harness.Spans(), "counters": {}, "profile": None, "window_s": 1.0,
             "jobs": 0, "server": {}, "requests": [], "tokens": []}
    for m in SPEC["per_layer"]:
        assert harness.metric_reader(m["name"])(empty) is None, m["name"]


class _FakePort:
    """Jobs that take a fixed wall time each."""

    device = "cpu"

    def __init__(self, walls):
        self.walls = list(walls)
        self.calls = 0

    def run(self, path):
        time.sleep(self.walls[self.calls % len(self.walls)])
        self.calls += 1


@pytest.mark.parametrize("seconds, passes", [(0.1, 1), (0.4, 2)])
def test_window_runs_whole_passes_and_counts_all_of_it(seconds, passes):
    port = _FakePort([0.05, 0.2, 0.05])
    elapsed, done = jobs.window(port, [("a", 10.0), ("b", 40.0), ("c", 10.0)], seconds=seconds)
    # the window ends with the pass that crosses `seconds`: the same jobs on
    # any host, never a pass cut short
    assert [a for a, _ in done] == [10.0, 40.0, 10.0] * passes
    assert elapsed >= 0.3 * passes
    rate = sum(a for a, _ in done) / elapsed
    assert rate == pytest.approx(60.0 * passes / elapsed)
    assert rate < 60.0 * passes / seconds  # all of the window's time, not the asked seconds


def test_percentile_counts_missing_requests_as_infinitely_late():
    values = [float(i) for i in range(1, 20)] + [None]
    assert harness.percentile(values, 95) == 19.0  # one missing of 20 is the 100th
    assert harness.percentile(values + [None], 95) == float("inf")
    assert harness.percentile([3.0, 1.0, 2.0], 50) == 2.0


class _OneLoopHandler(http.server.BaseHTTPRequestHandler):
    """Answers one request at a time (as one event loop does), each after
    `service_s`; a query 'fail' answers 500."""

    lock = threading.Lock()
    service_s = 0.1

    def do_GET(self):
        with self.lock:
            time.sleep(self.service_s)
        status = 500 if "q=fail" in self.path else 200
        body = json.dumps({"results": []}).encode()
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_open_loop_times_each_request_from_when_it_was_due():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _OneLoopHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        plan = [(0.0, "a"), (0.01, "b"), (0.02, "c"), (0.03, "fail")]
        res = asyncio.run(http_search._open_loop(server.server_address[1], plan, 10,
                                                 close_s=0.05, grace_s=5.0))
    finally:
        server.shutdown()
        server.server_close()
    lat = [r["latency"] if http_search.answered(r) else None for r in res]
    # served one after another: the third waits for the first two
    assert lat[2] >= 0.3 - 0.02 - 0.02
    assert lat[0] < lat[1] < lat[2]
    assert lat[3] is None  # a failure counts as missing
    assert harness.percentile(lat, 95) == float("inf")
    assert all(abs(r["late"]) < 0.05 for r in res)


def test_profile_reduction_unions_kernels_and_labels_gaps():
    assert harness._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    labels = harness._innermost_labels([1.0, 4.0, 9.0],
                                       [("outer", 0.0, 10.0), ("inner", 3.0, 5.0)])
    assert labels == ["outer", "inner", "outer"]
    assert harness._innermost_labels([1.0], []) == [""]


def test_process_age_is_the_time_since_start():
    age = harness.process_age_s()
    assert 0.0 < age < 24 * 3600


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    for dirpath, dirnames, files in os.walk(harness.BENCH_DIR):
        dirnames[:] = [d for d in dirnames if d not in ("tests", ".cache", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    found = {p: _imports(p) & set(harness.FORBIDDEN) for p in _sources()}
    assert not {p: s for p, s in found.items() if s}
    # the names are compared whole: the port's own name is not the JAX package's
    assert "eioku_tpu_torch" not in harness.FORBIDDEN
    assert any("eioku_tpu_torch" in _imports(p) for p in _sources())


def test_the_references_import_nothing_of_the_program():
    ref_dir = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            got = _imports(os.path.join(ref_dir, f))
            assert not got & {"eioku_tpu_torch", "eioku_tpu", "jax"}, f


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "eioku_tpu_torch_lookalike", types.ModuleType("x"))
    assert "eioku_tpu_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in harness.forbidden_modules()
