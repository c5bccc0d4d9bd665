"""Where the time goes in the PyTorch port's combined visual pass, on one GPU.

    python3 tools/torch_profile_slice.py

Uses chip_smoke.py's clip (60 s, 1280x720, 30 fps, planted colour cuts) and
the same task config (scenes + YOLOv8n objects, batch 64, random weights).
On the card it measures:

1. decode only: the pass's own decode loop (same sampling grid, geometry and
   decode threads) with no consumer -- the host decode floor;
2. the pass: one warm-up run, then one run under torch.profiler: wall time,
   device busy time (union of the kernels' intervals), the device's idle
   share of the wall, and device time by kernel name.

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

CONFIG = {"scene_detection": {}, "object_detection": {"batch_size": 64}}


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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("FAILED: needs CUDA", file=sys.stderr)
        return 2
    card = chip_smoke.nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="eioku_profile_") as workdir:
        clip = os.path.join(workdir, "clip.mp4")
        chip_smoke.write_clip(clip)
        decode_s, frames = decode_only_seconds(clip)
        engine = InferenceEngine(device="cuda")
        engine.run_task("visual_analysis", clip, CONFIG)  # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            engine.run_task("visual_analysis", clip, CONFIG)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        launches = _cuda.launch_counts()

    by_kernel: dict[str, float] = defaultdict(float)
    intervals = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us()
            intervals.append((e.time_range.start, e.time_range.end))
    busy_s = _union_us(intervals) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    report = {
        "card": card, "clip_seconds": chip_smoke.CLIP_SECONDS,
        "sampled_frames": frames, "decode_only_s": decode_s,
        "pass_wall_s": wall_s, "device_busy_s": busy_s if intervals else None,
        "device_idle_share": 1.0 - busy_s / wall_s if intervals else None,
        "launches": launches,
        "device_ms_by_kernel": {k: v / 1e3 for k, v in top},
    }
    print(f"card: {card}", file=sys.stderr)
    print(f"decode only: {decode_s:.3f} s for {frames} sampled frames; pass: "
          f"{wall_s:.3f} s wall, device busy {busy_s:.3f} s", file=sys.stderr)
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}", file=sys.stderr)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
