"""Drivers found by name: a cell whose driver is a new file runs without an
edit to any file the benchmark has, an unknown name is refused, and the
transcription cell does the same work through the closed loop.

    python -m pytest benchmark/tests/test_bench_drivers.py -q
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, run
from benchmark.drivers import closed_loop, http_search, jobs

PENDING = os.path.join(harness.BENCH_DIR, "pending", "minilm.search.json")

# A model's part of the closed loop, in a file of its own: each job scales
# a seeded vector; the check recomputes it in float64.
TOY_DRIVER = '''"""A toy model for the closed loop: a job scales a seeded vector."""
import os
import sys

import torch

from benchmark.drivers import closed_loop

RATE = "toy_items_per_s"
CHECKED = ("toy_err",)
COMPARED = "compared"


def _scale(x, s):
    return x * s


def write_jobs(folder, seed, traffic):
    os.makedirs(folder, exist_ok=True)
    out = []
    for i, n in enumerate([traffic["warmup_items"]] + traffic["items"]):
        path = os.path.join(folder, f"job{i:02d}.pt")
        torch.save(torch.randn(n, generator=torch.Generator().manual_seed(seed + i)), path)
        out.append((path, float(n)))
    return out[0][0], out[1:]


class Port:
    def __init__(self, model_cfg, device, cache):
        self.device, self.scale = device, model_cfg["config"]["scale"]

    def give(self, seed):
        pass

    def run(self, path):
        return _scale(torch.load(path), self.scale)

    def forget(self):
        pass

    def close(self):
        pass


def install_capture(spans, port, seed, traffic):
    capture = closed_loop.Reservoir(seed, traffic["check_jobs"])
    fn = port.run

    def run(path):
        out = fn(path)
        if capture.on:
            capture.offer({"path": path, "out": out})
        return out
    spans.patch(port, "run", run)
    return capture


def trace_wrappers(spans, traffic, model_cfg):
    spans.wrap(sys.modules[__name__], "_scale", "scale")
    return {"armed": False, "done": None, "slice_s": 0.0, "what": "none"}


def check(kept, model_cfg, seed, device, control=False):
    err = 0.0
    for rec in kept:
        ref = torch.load(rec["path"]).double() * model_cfg["config"]["scale"]
        err = max(err, float((rec["out"].double() - ref).abs().max()))
    return {"toy_err": err, "compared": len(kept)}


def layer_readings(model_cfg, done):
    return {}


def run(cell, seed, seconds, trace, rehearse):
    return closed_loop.run(sys.modules[__name__], cell, seed, seconds, trace, rehearse)
'''

TOY_READER = '''"""The toy model's scaling, per job of the window."""


def read(r):
    if not r["jobs"] or not r["spans"].records.get("scale"):
        return None
    return r["spans"].total("scale") / r["jobs"] * 1e3
'''


def _cells(driver: str, cell: str) -> dict:
    """A fragment of BENCHMARK.json: the toy configuration, one cell on the
    traffic `<cell>.json` and its metrics."""
    return {
        "configs": [{"name": "toy", "source": "https://example.org/toy",
                     "file": "benchmark/configs/toy.json", "reduced": [], "why": "a toy"}],
        "workloads": [{"name": cell, "config": "toy", "traffic": cell, "chips": 1,
                       "why": f"a closed loop through the driver {driver!r}"}],
        "end_to_end": [{"name": "toy_items_per_s", "unit": "items/s", "better": "higher",
                        "bound": 0.25, "source": "host_clock", "workloads": [cell]}],
        "per_layer": [{"name": "toy_scale_ms_per_job", "unit": "ms", "better": "lower",
                       "source": "program_span", "layer": "toy", "moves": "toy_items_per_s",
                       "workloads": [cell]}]}


def _digest(root: str) -> dict[str, str]:
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in (".cache", "__pycache__")]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A copy of BENCHMARK.json and benchmark/, with the toy model's files
    added beside the copied ones."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    copied = _digest(str(root))
    bench = root / "benchmark"
    (bench / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (bench / "metrics" / "toy_scale_ms_per_job.py").write_text(TOY_READER)
    (bench / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "config": {"scale": 3.0}, "job": {}, "limits": {"toy_err": 1e-6},
         "rehearse": {}}))
    return root, copied


def _run_py(root, cell: str, frag: dict, *extra: str) -> subprocess.CompletedProcess:
    path = root / f"{cell}.cells.json"
    path.write_text(json.dumps(frag))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2900000031",
         "--seconds", "0.2", "--rehearse", "--add-cells", str(path), *extra],
        cwd=root, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_new_driver_runs_as_new_files_only(tree, trace):
    root, copied = tree
    (root / "benchmark" / "traffic" / "toy.jobs.json").write_text(json.dumps(
        {"driver": "toy", "items": [1000, 3000], "warmup_items": 10, "check_jobs": 2,
         "rehearse": {}}))
    out = _run_py(root, "toy.jobs", _cells("toy", "toy.jobs"), "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["attempted"] % 2 == 0  # whole passes
    assert list(result["checks"]) == ["toy_err", "unchecked"]
    want = {"toy_scale_ms_per_job"} if trace == "1" else {"toy_items_per_s", "setup_s"}
    assert set(result["metrics"]) == want
    # the copied files are as they were: the cell is the added files alone
    now = _digest(str(root))
    assert {k: now[k] for k in copied} == copied


@pytest.mark.parametrize("name", ["no_such_driver", "Jobs", "../run", "jobs.py"])
def test_an_unknown_driver_exits_2_and_lists_the_drivers(tree, name):
    root, _ = tree
    cell = "bad." + "".join(c for c in name if c.isalnum() or c == "_")
    (root / "benchmark" / "traffic" / f"{cell}.json").write_text(json.dumps(
        {"driver": name, "rehearse": {}}))
    out = _run_py(root, cell, _cells(name, cell))
    assert out.returncode == 2, out.stderr[-3000:]
    assert not out.stdout.strip()
    assert "unknown driver" in out.stderr
    for present in ("closed_loop", "http_search", "jobs"):
        assert present in out.stderr


def test_the_two_drivers_resolve_to_their_modules():
    spec = harness.load_spec(PENDING)
    assert run._driver(harness.Cell(spec, "large-v3.transcribe")) is jobs
    assert run._driver(harness.Cell(spec, "minilm.search")) is http_search


def test_a_mode_the_driver_lacks_is_refused(capsys):
    assert not hasattr(jobs, "sweep")
    assert run.main(["--workload", "large-v3.transcribe", "--seed", "1", "--seconds", "1",
                     "--rehearse", "--sweep", "1,2"]) == 2
    assert "has no sweep()" in capsys.readouterr().err


# The rehearsal of the transcription cell at this seed, one pass (`--seconds`
# 0), as the driver gave it before the closed loop was split from it.
SEED = 2_900_000_029
PASS = {"attempted": 2, "audio_s": 115.0, "decoder_steps": [15, 15, 15], "windows": 3,
        "tokens": 39}


def test_the_transcription_rehearsal_does_the_same_work(monkeypatch):
    seen = {}
    window, install, check = closed_loop.window, jobs.install_capture, jobs.check

    def spy_window(*a):
        elapsed, seen["done"] = window(*a)
        return elapsed, seen["done"]

    def spy_install(*a):
        seen["capture"] = install(*a)
        return seen["capture"]

    def spy_check(*a, **kw):
        seen["r"] = check(*a, **kw)
        return seen["r"]
    monkeypatch.setattr(closed_loop, "window", spy_window)
    monkeypatch.setattr(jobs, "install_capture", spy_install)
    monkeypatch.setattr(jobs, "check", spy_check)
    cell = harness.Cell(harness.load_spec(), "large-v3.transcribe")
    result, checks = jobs.run(cell, SEED, 0.0, trace=False, rehearse=True)
    assert result["correct"], checks
    assert result["attempted"] == PASS["attempted"]
    assert sum(a for a, _ in seen["done"]) == PASS["audio_s"]
    assert list(checks) == ["mel_err", "enc_err", "dec_gap", "unchecked"]
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert [n for n, _ in seen["capture"].batches] == PASS["decoder_steps"]
    assert {k: seen["r"][k] for k in ("windows", "tokens")} == \
        {k: PASS[k] for k in ("windows", "tokens")}
