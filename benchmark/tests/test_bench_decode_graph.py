"""`decode_graph_pct`'s reader on synthetic task records: the share of the
window's decoder steps that replayed the step's CUDA graph.

    python -m pytest benchmark/tests/test_bench_decode_graph.py -q
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness


def _readings(counters: list[dict], monkeypatch) -> dict:
    """The window's readings over one job per entry of `counters`, each job
    a task record whose interval holds one of the window's own spans."""
    from eioku_tpu_torch.utils import metrics

    tasks = [{"id": i, "type": "transcription", "start_ns": i * 10 * 10**9,
              "end_ns": (i * 10 + 5) * 10**9, "ok": True, "spans": {}, "counters": c}
             for i, c in enumerate(counters)]
    monkeypatch.setattr(metrics, "METRICS", SimpleNamespace(recent_tasks=lambda: tasks))
    marks = [(i * 10 + 1.0, i * 10 + 2.0, {}) for i in range(len(counters))]
    return {"jobs": len(counters), "spans": SimpleNamespace(records={"decode": marks})}


@pytest.mark.parametrize("counters, want", [
    ([{"decode_steps": 127, "decode_graph_replays": 127, "decode_graph_captures": 1},
      {"decode_steps": 254, "decode_graph_replays": 254}], 100.0),
    ([{"decode_steps": 100, "decode_graph_replays": 100},
      {"decode_steps": 300, "decode_graph_replays": 0}], 25.0),
    ([{"decode_steps": 50, "decode_graph_replays": 0}], 0.0),
    ([{"decode_steps": 127}, {"decode_steps": 127}], None),
    ([{"decode_graph_replays": 0}], None),
], ids=["all-replayed", "a-mix", "eager", "no-counter", "no-steps"])
def test_decode_graph_pct(counters, want, monkeypatch):
    assert harness.metric_reader("decode_graph_pct")(_readings(counters, monkeypatch)) == want
