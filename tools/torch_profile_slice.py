"""Where the time goes in the PyTorch port's visual pass, on one GPU.

    python3 tools/torch_profile_slice.py

It uses chip_smoke.py's clip (60 s, 1280x720, 30 fps, planted colour cuts)
and two task configs, random weights: scenes + YOLOv8n objects (batch 64), and the full pass of chip_smoke.py (scenes, objects,
faces with embeddings, places, at their defaults). On the card it measures:

1. decode only: the pass's own decode loop (same sampling grid, geometry and
   decode threads) with no consumer -- the host decode floor;
2. each pass: one warm-up run; one run without the profiler, timing the
   host spans after the decode loop (HOST_SPANS: the face embeddings'
   re-decode with its crops, and the ArcFace part of it); then one run
   under torch.profiler: wall time, device busy time (union of the
   kernels' intervals), the device's idle share of the wall, and device
   time by kernel name and by category (K1 scene_diff, K2 nms, matrix
   products, copies, the rest), so that K1's and K2's device time inside
   the pass shows.

Transcription's time is the benchmark's (`benchmark/run.py --trace 1`) and
the program's own spans (`eioku_tpu_torch/utils/metrics.py`).

Prints a human-readable report on stderr and one JSON line on stdout.
Needs CUDA; exits nonzero without it.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the clip and config of the smoke run)

VISUAL_CONFIGS = {
    "scenes+objects": {"scene_detection": {}, "object_detection": {"batch_size": 64}},
    "full": chip_smoke.VISUAL_CONFIG,
}
# (module, attribute) whose wall seconds a visual pass reports: the whole
# post-pass embedding step, and the ArcFace batches inside it
HOST_SPANS = (("eioku_tpu_torch.ml.combined", "attach_face_embeddings"),
              ("eioku_tpu_torch.ml.detection", "_FaceCropCollector.attach_embeddings"))


def _timed_spans(run) -> tuple[float, dict]:
    """run() with each HOST_SPANS callable wrapped to add up its wall
    seconds: (run's wall seconds, {attribute: seconds})."""
    import importlib

    import torch

    spans, originals = {}, []
    for mod_name, attr in HOST_SPANS:
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        fn = getattr(owner, name)
        originals.append((owner, name, fn))

        def timed(*a, _fn=fn, _key=attr, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spans[_key] = spans.get(_key, 0.0) + time.perf_counter() - t
        setattr(owner, name, timed)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t, spans
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def decode_only_seconds(clip: str) -> tuple[float, int]:
    """The combined pass's decode loop alone: (wall seconds, frames)."""
    from eioku_tpu_torch.ml import video_io

    info = video_io.probe(clip)
    ds = 640 / max(info.width, info.height)
    dec_hw = (int(round(info.height * ds)) // 2 * 2,
              int(round(info.width * ds)) // 2 * 2)
    t = time.perf_counter()
    frames = 0
    for batch in video_io.prefetch(video_io.iter_frame_batches(
            clip, batch_size=32, frame_interval_s=0.25, resize_hw=dec_hw,
            decode_threads=4, fast_level=1)):
        frames += batch.valid
    return time.perf_counter() - t, frames


def _union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _device_events(prof):
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _category(name: str) -> str:
    low = name.lower()
    if "flash_hopper" in low or "flash_simt" in low:
        return "K3 flash_attention"
    if "nms_mask_kernel" in low or "nms_scan_kernel" in low:
        return "K2 nms"
    if "pair_abs_diff_kernel" in low:
        return "K1 scene_diff"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                              "gemv", "kernel2", "conv")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def _breakdown(prof, wall_s: float, top: int = 12) -> dict:
    by_kernel: dict[str, float] = defaultdict(float)
    by_cat: dict[str, float] = defaultdict(float)
    intervals = []
    events = _device_events(prof)
    for e in events:
        us = e.time_range.elapsed_us()
        by_kernel[e.name] += us
        by_cat[_category(e.name)] += us
        intervals.append((e.time_range.start, e.time_range.end))
    busy_s = _union_us(intervals) / 1e6
    return {"wall_s": wall_s, "device_busy_s": busy_s if intervals else None,
            "device_idle_share": 1.0 - busy_s / wall_s if intervals else None,
            "device_launches": len(events),
            "device_ms_by_category": {k: v / 1e3 for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
            "device_ms_by_kernel": {k: v / 1e3 for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:top]}}


def _profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    return out, prof, wall_s


def visual(card: str) -> dict:
    import torch

    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda

    with tempfile.TemporaryDirectory(prefix="eioku_profile_") as workdir:
        clip = os.path.join(workdir, "clip.mp4")
        chip_smoke.write_clip(clip)
        decode_s, frames = decode_only_seconds(clip)
        engine = InferenceEngine(device="cuda")
        passes = {}
        for name, config in VISUAL_CONFIGS.items():
            engine.run_task("visual_analysis", clip, config)  # warm-up
            plain_wall_s, spans = _timed_spans(
                lambda: engine.run_task("visual_analysis", clip, config))
            _cuda.reset_launch_counts()
            _, prof, wall_s = _profiled(
                lambda: engine.run_task("visual_analysis", clip, config))
            passes[name] = {"config": config, "launches": _cuda.launch_counts(),
                            "wall_s_no_profiler": plain_wall_s, "host_spans_s": spans,
                            **_breakdown(prof, wall_s)}
    report = {"card": card, "mode": "visual",
              "clip_seconds": chip_smoke.CLIP_SECONDS, "sampled_frames": frames,
              "decode_only_s": decode_s, "passes": passes}
    print(f"card: {card}", file=sys.stderr)
    print(f"decode only: {decode_s:.3f} s for {frames} sampled frames", file=sys.stderr)
    for name, part in passes.items():
        print(f"pass {name}: {part['wall_s']:.3f} s wall, device busy "
              f"{part['device_busy_s']:.3f} s, idle share "
              f"{part['device_idle_share']:.3f}, launches {part['launches']}; "
              f"without the profiler {part['wall_s_no_profiler']:.3f} s, host spans "
              f"{ {k: round(v, 3) for k, v in part['host_spans_s'].items()} }",
              file=sys.stderr)
        for cat, ms in part["device_ms_by_category"].items():
            print(f"  {ms:9.3f} ms  [{cat}]", file=sys.stderr)
        for kname, ms in part["device_ms_by_kernel"].items():
            print(f"  {ms:9.3f} ms  {kname[:100]}", file=sys.stderr)
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: needs CUDA", file=sys.stderr)
        return 2
    print(json.dumps(visual(chip_smoke.nvidia_smi_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
