"""Where the time goes in the PyTorch port's slices, on one GPU.

    python3 tools/torch_profile_slice.py [visual|transcription]

visual (the default) uses chip_smoke.py's clip (60 s, 1280x720, 30 fps,
planted colour cuts) and task config (scenes + YOLOv8n objects, batch 64,
random weights). On the card it measures:

1. decode only: the pass's own decode loop (same sampling grid, geometry and
   decode threads) with no consumer -- the host decode floor;
2. the pass: one warm-up run, then one run under torch.profiler: wall time,
   device busy time (union of the kernels' intervals), the device's idle
   share of the wall, and device time by kernel name and by category (K1
   scene_diff, K2 nms, matrix products, copies, the rest), so that K1's and
   K2's device time inside the pass shows.

transcription uses chip_smoke.py's 150 s wav (4 voiced 30 s windows) and
its full-width config (Whisper large-v3, random weights, bf16, batch 4, 224
tokens). After a warm-up run of the task it times one run of the whole task
(no profiler), then profiles, each on its own, the encoder call on the 4
windows and the task's greedy decode cut to its first DECODE_PROFILE_TOKENS
positions (a full decode is ~570k device events, more than the profiler's
post-processing handles in minutes). Each profile's device time is sorted
into K3, matrix products (cuBLAS/cuDNN kernels) and the rest; the decode's
is also given per step.

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
DECODE_PROFILE_TOKENS = 32


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
    if "flash_bf16_hopper" in low or "flash_simt" in low:
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


def transcription(card: str) -> dict:
    import numpy as np
    import torch

    from eioku_tpu_torch.ml import audio_io, transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.whisper.decoding import (
        build_suppress_masks,
        whisper_decode_windows,
    )
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import whisper_encode
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    config = chip_smoke.WHISPER_CONFIG
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="eioku_profile_") as workdir:
        wav = os.path.join(workdir, "speech.wav")
        chip_smoke.write_speech_wav(wav)
        engine = InferenceEngine(device="cuda")
        engine.run_task("transcription", wav, config)  # warm-up, loads the model
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.run_task("transcription", wav, config)
        torch.cuda.synchronize()
        task_wall_s = time.perf_counter() - t
        model, cfg, _ = transcribe._load_model(
            config["model"], None, "bfloat16", config["random_full_size"], dev)
        windows = audio_io.split_windows(audio_io.load_wav(wav))
        mel = log_mel_spectrogram(torch.from_numpy(
            np.stack([w for _, w in windows])).to(dev), n_mels=cfg.n_mels)
        enc, prof, wall = _profiled(lambda: whisper_encode(model, mel))
        encode = _breakdown(prof, wall)
        tk = WhisperTokens(cfg.vocab_size)
        sot = tk.sot_sequence("en")  # the task's greedy, no-timestamp prompt
        init = torch.tensor([sot] * len(windows), device=dev)
        sup_a, sup_b = build_suppress_masks(tk, timestamps=False)
        out, prof, wall = _profiled(lambda: whisper_decode_windows(
            model, enc, init, sup_a, sup_b, max_len=DECODE_PROFILE_TOKENS,
            beam_size=1, timestamps=False))
        decode = _breakdown(prof, wall)
        steps = DECODE_PROFILE_TOKENS - 1  # prefill + generated positions
        decode["steps"] = steps
        decode["launches_per_step"] = decode["device_launches"] / steps
        decode["wall_ms_per_step"] = wall / steps * 1e3
        decode["device_busy_ms_per_step"] = decode["device_busy_s"] / steps * 1e3
    report = {"card": card, "mode": "transcription", "config": config,
              "windows": len(windows), "task_wall_s": task_wall_s,
              "encode": encode, "decode": decode}
    print(f"card: {card}", file=sys.stderr)
    print(f"task: {task_wall_s:.3f} s wall (no profiler)", file=sys.stderr)
    print(f"decode: {decode['launches_per_step']:.0f} launches, "
          f"{decode['wall_ms_per_step']:.2f} ms wall and "
          f"{decode['device_busy_ms_per_step']:.2f} ms device busy per step",
          file=sys.stderr)
    for name in ("encode", "decode"):
        part = report[name]
        print(f"{name}: {part['wall_s']:.3f} s wall, device busy "
              f"{part['device_busy_s']:.3f} s, idle share "
              f"{part['device_idle_share']:.3f}, {part['device_launches']} launches",
              file=sys.stderr)
        for cat, ms in part["device_ms_by_category"].items():
            print(f"  {ms:9.3f} ms  [{cat}]", file=sys.stderr)
        for kname, ms in part["device_ms_by_kernel"].items():
            print(f"  {ms:9.3f} ms  {kname[:100]}", file=sys.stderr)
    return report


def visual(card: str) -> dict:
    import torch

    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda

    with tempfile.TemporaryDirectory(prefix="eioku_profile_") as workdir:
        clip = os.path.join(workdir, "clip.mp4")
        chip_smoke.write_clip(clip)
        decode_s, frames = decode_only_seconds(clip)
        engine = InferenceEngine(device="cuda")
        engine.run_task("visual_analysis", clip, CONFIG)  # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        _, prof, wall_s = _profiled(
            lambda: engine.run_task("visual_analysis", clip, CONFIG))
        launches = _cuda.launch_counts()
    report = {"card": card, "mode": "visual",
              "clip_seconds": chip_smoke.CLIP_SECONDS, "sampled_frames": frames,
              "decode_only_s": decode_s, "launches": launches,
              "pass": _breakdown(prof, wall_s)}
    print(f"card: {card}", file=sys.stderr)
    print(f"decode only: {decode_s:.3f} s for {frames} sampled frames; pass: "
          f"{wall_s:.3f} s wall, device busy {report['pass']['device_busy_s']:.3f} s",
          file=sys.stderr)
    for cat, ms in report["pass"]["device_ms_by_category"].items():
        print(f"  {ms:9.3f} ms  [{cat}]", file=sys.stderr)
    for name, ms in report["pass"]["device_ms_by_kernel"].items():
        print(f"  {ms:9.3f} ms  {name[:100]}", file=sys.stderr)
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: needs CUDA", file=sys.stderr)
        return 2
    modes = {"visual": visual, "transcription": transcription}
    mode = sys.argv[1] if len(sys.argv) > 1 else "visual"
    if mode not in modes:
        print(f"FAILED: unknown mode {mode!r} (visual or transcription)",
              file=sys.stderr)
        return 2
    print(json.dumps(modes[mode](chip_smoke.nvidia_smi_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
