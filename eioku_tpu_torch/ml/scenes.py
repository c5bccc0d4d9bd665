"""Scene detection: batched HSV frame-difference scoring on the device plus host
assembly (port of eioku_tpu/ml/scenes.py).

Frames are sampled at `sample_fps`, downscaled on the host, shipped as I420,
converted to HSV and scored on the device in fixed-shape batches with the
previous batch's last plane carried on the device; boundaries above
`threshold` become scene ranges subject to `min_scene_len_s`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.ops.colorspace import i420_frames_to_hsv_planes, to_i420
from eioku_tpu_torch.ops.scene_diff import scene_scores
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import resolve_device


# downscaled geometry for scoring: the metric is stable under downscale and
# the host->device transfer stays tiny
SCENE_H, SCENE_W = 96, 160


@dataclass
class Scene:
    scene_index: int
    start_ms: int
    end_ms: int
    score: float  # boundary strength that opened this scene (0 for the first)

    @property
    def duration_ms(self) -> int:
        return self.end_ms - self.start_ms


def detect_scenes(
    path: str,
    threshold: float = 0.1,
    min_scene_len_s: float = 0.5,
    sample_fps: float = 4.0,
    batch_size: int = 64,
    decode_threads: int = 4,
    decode_procs: int = 0,
    decode_fast: int = 1,
    device: str | torch.device | None = None,
) -> list[Scene]:
    dev = resolve_device(device)
    info = video_io.probe(path)
    duration_ms = info.duration_ms
    interval_s = 1.0 / max(sample_fps, 1e-6)

    boundaries: list[tuple[int, float]] = []  # (timestamp_ms, score)
    prev_plane = torch.zeros((SCENE_H * SCENE_W * 3,), dtype=torch.float32,
                             device=dev)
    first = True
    for batch in video_io.prefetch(video_io.iter_frame_batches(
            path, batch_size=batch_size, frame_interval_s=interval_s,
            resize_hw=(SCENE_H, SCENE_W), decode_threads=decode_threads,
            decode_procs=decode_procs, fast_level=decode_fast)):
        # ship I420 (half the bytes of RGB); the device converts and scores
        planes = i420_frames_to_hsv_planes(
            torch.from_numpy(to_i420(batch.frames)).to(dev))
        scores = scene_scores(prev_plane, planes).cpu().numpy()
        prev_plane = planes[max(batch.valid - 1, 0)]
        for slot in range(batch.valid):
            if first and slot == 0:
                first = False
                continue  # no predecessor for the very first sampled frame
            if scores[slot] > threshold:
                boundaries.append((int(batch.timestamps_ms[slot]),
                                   float(scores[slot])))
        if duration_ms > 0 and batch.valid:
            progress.report(batch.timestamps_ms[batch.valid - 1] / duration_ms)

    return assemble_scenes(boundaries, duration_ms, min_scene_len_s)


def assemble_scenes(boundaries: list[tuple[int, float]], duration_ms: int,
                    min_scene_len_s: float = 0.5) -> list[Scene]:
    """Turn boundary timestamps into contiguous scene ranges covering the video.

    Boundaries closer than min_scene_len to the previous scene start are
    merged (flash suppression). Falls back to a single whole-video scene when
    no boundary fires.
    """
    min_len_ms = int(min_scene_len_s * 1000)
    starts: list[tuple[int, float]] = [(0, 0.0)]
    for ts, score in sorted(boundaries):
        if ts - starts[-1][0] >= min_len_ms and ts < duration_ms:
            starts.append((ts, score))
    scenes: list[Scene] = []
    for i, (start, score) in enumerate(starts):
        end = starts[i + 1][0] if i + 1 < len(starts) else max(duration_ms, start)
        scenes.append(Scene(scene_index=i, start_ms=start, end_ms=end, score=score))
    return scenes


def scene_rows(scenes: list[Scene]) -> list[dict]:
    """Scene results in the engine's {"payload", "span_*_ms"} row shape."""
    return [
        {"payload": {"scene_index": s.scene_index, "start_ms": s.start_ms,
                     "end_ms": s.end_ms, "duration_ms": s.duration_ms,
                     "score": round(s.score, 4)},
         "span_start_ms": s.start_ms, "span_end_ms": s.end_ms}
        for s in scenes
    ]
