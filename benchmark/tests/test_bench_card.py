"""Each cell once on the card, at a short window: the result line is whole
and the outputs are correct. Marked `cuda`; skips without a card.

    python -m pytest --noconftest benchmark/tests/test_bench_card.py -q
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

PENDING = os.path.join(harness.BENCH_DIR, "pending", "minilm.search.json")
SPEC = harness.load_spec(PENDING)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed", "4000000007",
         "--seconds", "5", "--trace", "0", "--add-cells", PENDING], cwd=harness.ROOT,
        capture_output=True, text=True,
        timeout=1200, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    cell = harness.Cell(SPEC, name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
