"""Combined visual analysis: one decode pass feeds scene scoring and object
detection (port of eioku_tpu/ml/combined.py, scenes + objects).

The video is decoded once at the finest sampling rate and frames are routed
to each consumer:

  - scene scoring takes every sampled frame (host resize to 96x160 -> I420
    upload -> device HSV -> scene-diff kernel), in fixed 256-slot chunks;
  - object detection takes the subset on its interval, accumulated into
    fixed-size batches and dispatched to the device asynchronously.

Results are returned per task type. Places, faces and OCR, the other
consumers of the JAX package's pass, are not ported yet: a config that
carries one of them raises ModelNotAvailable.
"""
from __future__ import annotations

import os
import shutil

import cv2
import numpy as np
import torch

from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.ml.detection import (
    INPUT_SIZE,
    _load_model,
    check_supported,
    emit_boxes,
    fetch,
    letterbox_batch,
)
from eioku_tpu_torch.ml.engine import ModelNotAvailable
from eioku_tpu_torch.ml.scenes import SCENE_H, SCENE_W, assemble_scenes, scene_rows
from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
from eioku_tpu_torch.models.yolo.postprocess import detect, pad_offsets_for
from eioku_tpu_torch.ops.colorspace import (
    i420_frames_to_hsv_planes,
    i420_to_rgb,
    to_i420,
)
from eioku_tpu_torch.ops.scene_diff import scene_scores
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import resolve_device


SCENE_CHUNK = 256
_UNPORTED_SUBTASKS = ("face_detection", "place_classification", "ocr")


def _detect_i420(model, planes: torch.Tensor, conf_threshold: float) -> dict:
    """Upload-lean detection: I420 planes in, the whole detect graph on the
    device. detect() keeps its default candidate pool (top_k 256): the
    combined pass, like the JAX package's, does not read
    object_detection.top_k (the standalone object_detection task does)."""
    return detect(model, i420_to_rgb(planes), conf_threshold=conf_threshold)


class _DetectionConsumer:
    """Accumulates sampled frames into fixed batches for the object detector.

    Offered frames may be pre-downscaled by the shared decode pass;
    coord_scale maps detector coordinates back to source pixels so payloads
    stay in original-frame coordinates."""

    # bounds queued device work: each undrained flush pins its uploaded batch
    MAX_PENDING = 16

    def __init__(self, model_name: str, conf: float, step: int,
                 batch_size: int, cache_dir, frame_ms: int,
                 src_wh: tuple[int, int], coord_scale: float,
                 device: torch.device):
        self.model = _load_model(model_name, len(COCO_CLASSES), cache_dir,
                                 device)
        self.device = device
        self.conf = conf
        self.step = max(step, 1)
        self.batch_size = batch_size
        self.frame_ms = frame_ms
        self.src_wh = src_wh
        self.coord_scale = coord_scale
        self._frames: list[np.ndarray] = []
        self._meta: list[tuple[int, int]] = []  # (frame_idx, t_ms)
        self._pending: list[tuple] = []  # dispatched, not yet fetched
        self.results: list[dict] = []

    def offer(self, frame: np.ndarray, frame_idx: int, t_ms: int) -> None:
        if frame_idx % self.step != 0:
            return
        self._frames.append(frame)
        self._meta.append((frame_idx, t_ms))
        if len(self._frames) == self.batch_size:
            self.flush()

    def flush(self) -> None:
        """Dispatch the batch to the device without fetching its results:
        CUDA work is asynchronous, so detection overlaps decode and scene
        scoring; drain() fetches."""
        if not self._frames:
            return
        valid = len(self._frames)
        # bucket partial batches to the next power of two: a final 20-frame
        # flush uploads a 32-slot batch, not the full 64
        bucket = self.batch_size
        for c in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            if valid <= c <= self.batch_size:
                bucket = c
                break
        stack = np.stack(self._frames + [np.zeros_like(self._frames[0])]
                         * (bucket - valid))
        h, w = stack.shape[1:3]
        if max(h, w) == INPUT_SIZE:
            # decode already delivered detector-scale frames: upload the
            # real pixels only and let detect() pad to stride alignment on
            # the device
            scale, pads = 1.0, pad_offsets_for(h, w)
            boxed = stack
        else:
            boxed, scale, pads = letterbox_batch(stack, valid)
        if boxed.shape[1] % 2 == 0 and boxed.shape[2] % 2 == 0:
            # ship I420 (half the bytes); the device converts back
            planes = torch.from_numpy(to_i420(list(boxed))).to(self.device)
            out = _detect_i420(self.model, planes, self.conf)
        else:  # odd geometry can't subsample chroma: plain RGB upload
            out = detect(self.model, torch.from_numpy(boxed).to(self.device),
                         conf_threshold=self.conf)
        self._pending.append((out, self._meta, scale, pads, valid))
        self._frames, self._meta = [], []
        if len(self._pending) >= self.MAX_PENDING:
            self.drain()

    def drain(self) -> None:
        for out, meta, scale, pads, valid in self._pending:
            emit_boxes(self.results, fetch(out), meta, scale, pads, valid,
                       self.coord_scale, self.src_wh, self.frame_ms,
                       COCO_CLASSES)
        self._pending = []


def run_visual_analysis(video_path: str, config: dict,
                        model_cache_dir: str | None = None,
                        device: str | torch.device | None = None
                        ) -> dict[str, list[dict]]:
    """Returns {task_type: results} for scene_detection and object_detection
    (each present when its sub-config is) from ONE decode pass."""
    for key in _UNPORTED_SUBTASKS:
        if config.get(key) is not None:
            raise ModelNotAvailable(
                f"visual_analysis sub-task {key!r} is not ported to "
                "eioku_tpu_torch (scene_detection and object_detection are)")
    scfg = config.get("scene_detection")
    ocfg = config.get("object_detection")
    if ocfg is not None:
        check_supported(ocfg)
    dev = resolve_device(device)

    info = video_io.probe(video_path)
    fps = info.fps or 30.0
    frame_ms = int(round(1000.0 / fps))
    # base sampling grid: the scene cadence when scenes run, else the object
    # cadence
    if scfg is not None:
        interval_s = 1.0 / max(float(scfg.get("sample_fps", 4.0)), 1e-6)
    elif ocfg is not None:
        interval_s = float(ocfg.get("frame_interval_s", 1.0))
    else:
        interval_s = 1.0
    base_step = max(int(round(fps * interval_s)), 1)

    def substep(seconds: float) -> int:
        # consumer steps are in source-frame units, aligned to the base grid
        return max(int(round(fps * seconds / base_step)), 1) * base_step

    # decode directly at the detector's long-side geometry (aspect
    # preserved): scenes derive from ~1/4 the source pixels and detection
    # letterboxing becomes pad-only; boxes map back via coord_scale
    det_long = int(config.get("detector_size", 640))
    ds = det_long / max(info.width, info.height, 1)
    if ds < 1.0:
        dec_hw = (max(int(round(info.height * ds)), 2) // 2 * 2,
                  max(int(round(info.width * ds)), 2) // 2 * 2)
        coord_scale = info.width / dec_hw[1]
    else:
        dec_hw = None
        coord_scale = 1.0

    objects = _DetectionConsumer(
        ocfg.get("model", "yolov8n"),
        float(ocfg.get("confidence_threshold", 0.5)),
        substep(float(ocfg.get("frame_interval_s", 1.0))),
        int(ocfg.get("batch_size", 64)),
        model_cache_dir, frame_ms, (info.width, info.height), coord_scale,
        dev) if ocfg is not None else None

    # scene state: sampled frames accumulate into fixed 256-slot chunks;
    # score tensors stay on the device until the post-pass and the
    # previous-plane carry is device-side
    threshold = float(scfg.get("threshold", 0.1)) if scfg is not None else 0.0
    prev_plane = torch.zeros((SCENE_H * SCENE_W * 3,), dtype=torch.float32,
                             device=dev)
    scene_buf: list[np.ndarray] = []  # 96x160 frames awaiting scoring
    scene_stamps: list[int] = []
    scene_pending: list[tuple] = []  # (scores_dev, timestamps, valid)

    def flush_scenes():
        nonlocal prev_plane
        if not scene_buf:
            return
        valid = len(scene_buf)
        stack = scene_buf + [np.zeros_like(scene_buf[0])] \
            * (SCENE_CHUNK - valid)
        planes = i420_frames_to_hsv_planes(
            torch.from_numpy(to_i420(stack)).to(dev))
        scene_pending.append((scene_scores(prev_plane, planes),
                              list(scene_stamps), valid))
        prev_plane = planes[valid - 1]
        scene_buf.clear()
        scene_stamps.clear()

    # keyframe cache: persist 1 s-grid frames as JPEGs so the downstream
    # visual-index task reads them instead of re-decoding the source
    kf_dir = config.get("keyframe_cache_dir")
    kf_step = 0
    if kf_dir:
        shutil.rmtree(kf_dir, ignore_errors=True)  # replace a stale cache
        os.makedirs(kf_dir, exist_ok=True)
        kf_step = substep(float(config.get("keyframe_cache_interval_s", 1.0)))

    for batch in video_io.prefetch(video_io.iter_frame_batches(
            video_path, batch_size=int(config.get("batch_size", 32)),
            frame_interval_s=interval_s, resize_hw=dec_hw,
            decode_threads=int(config.get("decode_threads", 4)),
            decode_procs=int(config.get("decode_procs", 0)),
            fast_level=int(config.get("decode_fast", 1)))):
        if kf_step:
            for i in range(batch.valid):
                if int(batch.frame_indices[i]) % kf_step == 0:
                    cv2.imwrite(
                        os.path.join(kf_dir,
                                     f"{int(batch.timestamps_ms[i])}.jpg"),
                        cv2.cvtColor(batch.frames[i], cv2.COLOR_RGB2BGR))
        if scfg is not None:
            # scene scoring needs only 96x160: resize on the host so the
            # upload is ~40x smaller than full-resolution frames
            for i in range(batch.valid):
                scene_buf.append(cv2.resize(batch.frames[i],
                                            (SCENE_W, SCENE_H),
                                            interpolation=cv2.INTER_AREA))
                scene_stamps.append(int(batch.timestamps_ms[i]))
                if len(scene_buf) == SCENE_CHUNK:
                    flush_scenes()
        if objects is not None:
            for slot in range(batch.valid):
                # .copy(): a view would pin the whole decode batch in memory
                # until the consumer's next flush
                objects.offer(batch.frames[slot].copy(),
                              int(batch.frame_indices[slot]),
                              int(batch.timestamps_ms[slot]))
        if info.duration_ms > 0 and batch.valid:
            # the post-loop drain is a small tail; cap decode at 95%
            progress.report(0.95 * batch.timestamps_ms[batch.valid - 1]
                            / info.duration_ms)
    # final partial batches all dispatch before anything drains
    if scfg is not None:
        flush_scenes()
    if objects is not None:
        objects.flush()
        objects.drain()

    out: dict[str, list[dict]] = {}
    if scfg is not None:
        boundaries: list[tuple[int, float]] = []
        first = True
        for scores_dev, stamps, valid in scene_pending:
            scores = scores_dev.cpu().numpy()
            for slot in range(valid):
                if first and slot == 0:
                    first = False
                elif scores[slot] > threshold:
                    boundaries.append((int(stamps[slot]),
                                       float(scores[slot])))
        out["scene_detection"] = scene_rows(assemble_scenes(
            boundaries, info.duration_ms,
            float(scfg.get("min_scene_len_s", 0.5))))
    if objects is not None:
        out["object_detection"] = objects.results
    return out
