"""The port's tracer (`eioku_tpu_torch/utils/metrics.py`): spans and counters
of a task, their totals and self times, the bounded buffer of recent tasks,
contexts on threads, the registry left as the JAX package's, the program's
outputs with the tracer live and stubbed, and the merge into the program's
own profile.
"""
import asyncio
import json
import sys
import threading
import time
import wave
from collections import Counter
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from eioku_tpu_torch.ml import transcribe
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.whisper import decoding
from eioku_tpu_torch.models.whisper.decoding import build_suppress_masks
from eioku_tpu_torch.models.whisper.model import WhisperConfig, init_whisper, whisper_encode
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens
from eioku_tpu_torch.utils import metrics
from eioku_tpu_torch.utils.metrics import (METRICS, MetricsRegistry, TaskMetrics, maybe_profile,
                                          merge_spans, to_prometheus)

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class _Clock:
    """perf_counter_ns at a time the test sets."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now


def _run_tree(reg, clock, node, task_type="t"):
    """Open node = (name, start, end, children) at its times; the root is
    the task."""
    name, t0, t1, kids = node
    clock.now = t0
    with reg.task(task_type) if name == "task" else reg.span(name):
        for kid in kids:
            _run_tree(reg, clock, kid, task_type)
        clock.now = t1


def _kept():
    """Keep every span's interval in this context (as maybe_profile does)."""
    kept = []
    return kept, metrics._KEPT_SPANS.set(kept)


# -- nesting, self time, totals -------------------------------------------------------


@pytest.mark.parametrize("tree, links", [
    (("task", 0, 9, []), [("task", None)]),
    (("task", 0, 9, [("a", 1, 8, [("b", 2, 3, [])])]),
     [("b", "a"), ("a", "task"), ("task", None)]),
    (("task", 0, 9, [("a", 1, 2, []), ("b", 3, 4, [("c", 3, 4, [])])]),
     [("a", "task"), ("c", "b"), ("b", "task"), ("task", None)]),
], ids=["root", "nested", "siblings"])
def test_spans_nest_and_link_their_parents(tree, links, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(metrics, "time", clock)
    reg = TaskMetrics()
    kept, token = _kept()
    try:
        _run_tree(reg, clock, tree)
    finally:
        metrics._KEPT_SPANS.reset(token)
    # in closing order, each with its parent's name and the one task's id
    assert [(k[0], k[5]) for k in kept] == links
    (task,) = reg.recent_tasks()
    assert {k[3] for k in kept} == {task["id"]} and {k[4] for k in kept} == {"t"}
    assert metrics._OPEN_SPAN.get() is None
    with reg.span("outside"):  # no task open: nothing is recorded
        reg.count("outside")
    assert len(reg.recent_tasks()) == 1


@pytest.mark.parametrize("tree, want", [
    (("task", 0, 100, [("a", 10, 40, [("b", 15, 25, [])]), ("c", 50, 60, [])]),
     {"task": (1, 100, 60), "a": (1, 30, 20), "b": (1, 10, 10), "c": (1, 10, 10)}),
    (("task", 0, 50, [("s", 0, 10, []), ("s", 10, 30, [("s", 12, 14, [])])]),
     {"task": (1, 50, 20), "s": (3, 32, 30)}),
    (("task", 0, 7, [("a", 0, 7, [("b", 0, 7, [])])]),
     {"task": (1, 7, 0), "a": (1, 7, 0), "b": (1, 7, 7)}),
], ids=["tree", "repeated-name", "covered"])
def test_self_time_is_the_span_less_its_children(tree, want, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(metrics, "time", clock)
    reg = TaskMetrics()
    _run_tree(reg, clock, tree)
    (task,) = reg.recent_tasks()
    got = {n: (s["count"], s["total_ns"], s["self_ns"]) for n, s in task["spans"].items()}
    assert got == want
    assert (task["start_ns"], task["end_ns"]) == (tree[1], tree[2])


@pytest.mark.parametrize("counts, want", [
    ([("a", 1), ("a", 3), ("b", 2.5)], {"a": 4, "b": 2.5}),
    ([("decode_steps", 127)] * 10, {"decode_steps": 1270}),
    ([], {}),
], ids=["mixed", "steps", "none"])
def test_task_totals_and_counters(counts, want):
    reg = TaskMetrics()
    reg.count("a", 100)  # outside a task: nothing
    for task_type in ("x", "y"):
        with reg.task(task_type):
            for name, n in counts:
                with reg.span("step"):
                    reg.count(name, n)
    records = reg.recent_tasks()
    assert [r["type"] for r in records] == ["x", "y"]
    assert records[0]["id"] < records[1]["id"]
    for r in records:
        assert r["counters"] == want and r["ok"]
        assert r["spans"].get("step", {}).get("count", 0) == len(counts)
    # the task records stay in the buffer: the registry's own metrics are untouched
    assert reg.snapshot() == {"counters": {}, "timings": {}}


@pytest.mark.parametrize("tasks, steps", [(metrics.RECENT_TASKS + 7, 3), (5, 20_000)])
def test_recent_tasks_stay_bounded(tasks, steps):
    reg = TaskMetrics()
    for _ in range(tasks):
        with reg.task("t"):
            for _ in range(steps):
                with reg.span("decode.forward"):
                    pass
                reg.count("decode_steps")
    records = reg.recent_tasks()
    assert len(records) == min(tasks, metrics.RECENT_TASKS)
    assert [r["id"] for r in records] == list(range(tasks - len(records) + 1, tasks + 1))
    for r in records:  # per name, not per span: a step adds no memory
        assert set(r["spans"]) == {"task", "decode.forward"}
        assert r["spans"]["decode.forward"]["count"] == steps
        assert r["counters"] == {"decode_steps": steps}


def test_a_failed_task_is_recorded_and_closes_its_spans():
    reg = TaskMetrics()
    with pytest.raises(ValueError):
        with reg.task("t"), reg.span("a"):
            raise ValueError("boom")
    (r,) = reg.recent_tasks()
    assert not r["ok"] and set(r["spans"]) == {"task", "a"}
    assert metrics._OPEN_SPAN.get() is None


# -- contexts on threads -----------------------------------------------------------------


def _steps(reg, tag, steps, barrier=None):
    for _ in range(steps):
        if barrier is not None:
            barrier.wait(timeout=30)
        with reg.span("step." + tag):
            reg.count("n." + tag)


def _task_on_thread(reg, barrier, tag, steps):
    with reg.task(tag):
        _steps(reg, tag, steps, barrier)


@pytest.mark.parametrize("mode, workers, tasks", [
    ("threads", 2, 1), ("to_thread", 2, 1), ("stress", 16, 12)])
def test_tasks_on_threads_stay_apart(mode, workers, tasks):
    reg = TaskMetrics()
    steps = 25
    if mode == "to_thread":
        # the engine's call: a task opened on the event loop, its spans in
        # asyncio.to_thread's worker, which runs in a copy of the context
        async def one(tag):
            with reg.task(tag):
                await asyncio.to_thread(_steps, reg, tag, steps)

        async def both():
            await asyncio.gather(one("w0"), one("w1"))
        asyncio.run(both())
    else:
        barrier = threading.Barrier(workers) if mode == "threads" else None
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda i=i: [
                _task_on_thread(reg, barrier, f"w{i}", steps) for _ in range(tasks)])
                for i in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
    records = reg.recent_tasks()
    assert len(records) == workers * tasks
    assert len({r["id"] for r in records}) == len(records)
    for r in records:
        tag = r["type"]
        assert set(r["spans"]) == {"task", "step." + tag}
        assert r["spans"]["step." + tag]["count"] == steps
        assert r["counters"] == {"n." + tag: steps}
    # no record lost under the lock
    assert Counter(r["type"] for r in records) == {f"w{i}": tasks for i in range(workers)}


# -- the registry's surface ------------------------------------------------------------------


@pytest.mark.parametrize("tasks", [1, 3])
def test_tasks_leave_the_registry_as_the_jax_one(tasks):
    """The task handler's metrics read as in a plain registry, whatever the
    tasks around them; reset clears both."""
    plain, reg = MetricsRegistry(), TaskMetrics()
    for _ in range(tasks):
        for r in (plain, reg):
            r.inc("tasks_completed", task_type="transcription")
            r.observe("task_seconds", 0.25, task_type="transcription")
        with reg.task("transcription"):
            for _ in range(5):
                with reg.span("decode.forward"):
                    pass
            reg.count("decode_steps", 5)
    assert reg.snapshot() == plain.snapshot()
    assert to_prometheus(reg.snapshot()) == to_prometheus(plain.snapshot())
    assert [t["counters"] for t in reg.recent_tasks()] == [{"decode_steps": 5}] * tasks
    reg.reset()
    assert reg.recent_tasks() == [] and reg.snapshot() == {"counters": {}, "timings": {}}


# -- the program with the tracer ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = WhisperConfig("tiny")
    return init_whisper(cfg, torch.Generator().manual_seed(0)), cfg


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """35 s of a voiced tone (two windows) and a vocabulary of word pieces."""
    d = tmp_path_factory.mktemp("tracing")
    rng = np.random.default_rng(0)
    t = np.arange(SR * 35) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)
    with wave.open(str(d / "clip.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    (d / "vocab.json").write_text(json.dumps({f"Ġw{i}": i for i in range(50257)}))
    return d


def _decode(tiny):
    model, cfg = tiny
    mel = torch.randn(2, cfg.n_mels, 3000, generator=torch.Generator().manual_seed(1))
    enc = whisper_encode(model, mel)
    tk = WhisperTokens(cfg.vocab_size)
    init = torch.tensor([tk.sot_sequence("en")] * 2)
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    with METRICS.task("decode"):
        return decoding.whisper_decode_windows(model, enc, init, sup_a, sup_b, max_len=10,
                                               beam_size=5, timestamps=True)


def _transcription(tiny, clip_dir):
    return InferenceEngine(model_cache_dir=str(clip_dir), device="cpu").run_task(
        "transcription", str(clip_dir / "clip.wav"),
        {"model": "tiny", "compute_dtype": "float32", "temperatures": [], "max_tokens": 8,
         "batch_size": 4, "no_speech_threshold": 2.0})


def _stub_tracer(monkeypatch):
    monkeypatch.setattr(TaskMetrics, "task", lambda self, task_type: nullcontext())
    monkeypatch.setattr(TaskMetrics, "span", lambda self, name: nullcontext())
    monkeypatch.setattr(TaskMetrics, "count", lambda self, name, n=1: None)


@pytest.mark.parametrize("entry", ["decode", "transcription"])
def test_outputs_equal_with_the_tracer_live_and_stubbed(entry, tiny, clip_dir, monkeypatch):
    monkeypatch.setattr(transcribe, "_load_model", lambda *a, **kw: (*tiny, True))
    steps = []
    step_fn = decoding.decoder_step

    def counted_step(*a):
        steps.append(1)
        return step_fn(*a)
    monkeypatch.setattr(decoding, "decoder_step", counted_step)
    run = (lambda: _decode(tiny)) if entry == "decode" else \
        (lambda: _transcription(tiny, clip_dir))
    live = run()
    record = METRICS.recent_tasks()[-1]
    live_steps = len(steps)
    with monkeypatch.context() as m:
        _stub_tracer(m)
        stubbed = run()
    if entry == "decode":
        assert all(torch.equal(a, b) for a, b in zip(live, stubbed))
    else:
        assert live == stubbed and live
    # the program's counts are the decoder_step calls and the batch slots
    assert record["counters"]["decode_steps"] == live_steps == len(steps) - live_steps
    spans = record["spans"]
    decodes, loop = spans["decode.prefill"]["count"], spans["decode.forward"]["count"]
    n_init = len(WhisperTokens(tiny[1].vocab_size).sot_sequence(
        "en", timestamps=entry == "transcription"))
    assert loop + decodes * (n_init - 1) == live_steps
    # one wait a step, and one more where every beam finished before the cap
    assert loop <= spans["decode.sync"]["count"] <= loop + decodes
    if entry == "transcription":
        # two windows in one batch of 4, and the language detection's one
        assert (record["counters"]["window_slots"], record["counters"]["padded_slots"]) == (5, 2)
        assert {"audio.find", "audio.load", "audio.windows", "load_model", "lang_detect",
                "mel", "encode", "decode", "copy_back", "fallback", "rows"} <= set(spans)


def test_another_profiler_sees_no_program_span(tiny):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _decode(tiny)
    names = {e.name for e in prof.events()}
    spans = set(METRICS.recent_tasks()[-1]["spans"])
    assert {"task", "decode.forward", "decode.select", "decode.sync"} <= spans
    assert not names & spans
    assert "aten::mm" in names or "aten::addmm" in names


def test_maybe_profile_merges_the_program_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("EIOKU_PROFILE_DIR", str(tmp_path))
    a = torch.randn(256, 256)
    with maybe_profile("transcription"):
        with METRICS.task("transcription"), METRICS.span("outer"):
            with METRICS.span("matmul"):
                time.sleep(0.002)
                torch.mm(a, a)
                time.sleep(0.002)
            METRICS.count("n")
    with METRICS.task("after"), METRICS.span("outer"):  # the capture has ended
        pass
    (trace,) = tmp_path.glob("transcription-*/trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert sorted(mine) == ["matmul", "outer", "task"]
    assert mine["matmul"]["args"]["parent"] == "outer"
    assert mine["task"]["args"]["task_type"] == "transcription"
    assert len({(e["pid"], e["tid"]) for e in mine.values()}) == 1
    names = [e for e in events if e.get("ph") == "M" and e["tid"] == mine["task"]["tid"]]
    assert names and names[0]["args"]["name"].startswith("program spans")
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    span = mine["matmul"]
    # the span's interval, on the trace's clock, holds the op it enclosed
    assert span["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]
    assert mine["outer"]["ts"] <= span["ts"] and span["dur"] <= mine["outer"]["dur"]


def _torch_trace(path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8).mul_(2)
    prof.export_chrome_trace(str(path))


def _events(n):
    return [{"ph": "X", "name": f"op{i}", "pid": 1, "tid": 1, "ts": i, "dur": 1}
            for i in range(n)]


# the trace shapes the merge meets: torch's own, an empty array, other
# members after the array (one with a "]" in a string), a trace larger than
# the head and tail that the merge reads
@pytest.mark.parametrize("shape", ["torch", "empty", "members-after", "large"])
def test_merge_appends_in_place_and_keeps_every_event(shape, tmp_path):
    path = tmp_path / "trace.json"
    if shape == "torch":
        _torch_trace(path)
    else:
        events = {"empty": [], "members-after": _events(3), "large": _events(5000)}[shape]
        doc = {"schemaVersion": 1, "baseTimeNanoseconds": 7_000_000, "traceEvents": events}
        if shape == "members-after":
            doc["traceName"] = "a]b.json"
        path.write_text(json.dumps(doc, indent=2))
    before = json.loads(path.read_text())
    spans = [("decode.forward", 2_000_000, 5_000_000, 4, "transcription", "decode", 11),
             ("task", 1_000_000, 9_000_000, 4, "transcription", None, 12)]
    merge_spans(str(path), spans, 10_000_000)
    after = json.loads(path.read_text())
    n = len(before["traceEvents"])
    assert after["traceEvents"][:n] == before["traceEvents"]
    assert {k: v for k, v in after.items() if k != "traceEvents"} == \
        {k: v for k, v in before.items() if k != "traceEvents"}
    mine = after["traceEvents"][n:]
    base = int(before.get("baseTimeNanoseconds", 0))
    assert [(e["name"], e["ts"], e["dur"]) for e in mine if e["ph"] == "X"] == [
        ("decode.forward", (12_000_000 - base) / 1e3, 3e3),
        ("task", (11_000_000 - base) / 1e3, 8e3)]
    assert {e["tid"] for e in mine} == {metrics._SPAN_TRACK + 11, metrics._SPAN_TRACK + 12}
    assert sorted(e["args"]["name"] for e in mine if e["ph"] == "M") == [
        "program spans, thread 11", "program spans, thread 12"]


@pytest.mark.parametrize("content, raises", [
    (None, False),  # no spans: the trace stays as torch wrote it
    ('{"traceEvents": {}}', True),
    ('{"traceEvents": [', True),
], ids=["no-spans", "no-array", "cut-short"])
def test_merge_leaves_a_trace_without_spans_and_refuses_one_without_an_array(
        content, raises, tmp_path):
    path = tmp_path / "trace.json"
    if content is None:
        _torch_trace(path)
    else:
        path.write_text(content)
    raw = path.read_bytes()
    if raises:
        with pytest.raises(ValueError, match="no traceEvents array"):
            merge_spans(str(path), [("task", 0, 1, 1, "t", None, 1)], 0)
    else:
        merge_spans(str(path), [], 0)
    assert path.read_bytes() == raw
