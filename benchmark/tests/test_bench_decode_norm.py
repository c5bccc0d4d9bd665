"""`decode_norm_kernel_pct`'s reader on synthetic task records: the share
of the window's decoder steps whose residual adds and LayerNorms went
through the add-and-LayerNorm kernel.

    python -m pytest benchmark/tests/test_bench_decode_norm.py -q
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
    ([{"decode_steps": 127, "decode_norm_kernel_steps": 127},
      {"decode_steps": 254, "decode_norm_kernel_steps": 254}], 100.0),
    ([{"decode_steps": 100, "decode_norm_kernel_steps": 100},
      {"decode_steps": 300, "decode_norm_kernel_steps": 0}], 25.0),
    ([{"decode_steps": 50, "decode_norm_kernel_steps": 0}], 0.0),
    ([{"decode_steps": 127, "decode_attn_kernel_steps": 127}], None),
    ([{"decode_norm_kernel_steps": 0}], None),
], ids=["all-kernel", "a-mix", "plain", "no-counter", "no-steps"])
def test_decode_norm_kernel_pct(counters, want, monkeypatch):
    assert harness.metric_reader("decode_norm_kernel_pct")(_readings(counters, monkeypatch)) == want
