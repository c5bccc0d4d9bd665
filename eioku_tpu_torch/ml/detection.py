"""Object detection over batched video frames (port of eioku_tpu/ml/detection.py,
objects only).

Frames are letterboxed on the host into fixed 640x640 batches and the whole
forward + decode + top-K + NMS graph runs on the device per batch; boxes are
un-letterboxed back to source pixels on the host.

Checkpoints: `{model}.pt` (ultralytics format) under model_cache_dir, else
random-init weights from a seeded `torch.Generator` with a warning, so the
pipeline stays runnable without downloads.
"""
from __future__ import annotations

import logging
import os
from functools import lru_cache

import cv2
import numpy as np
import torch

from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.ml.engine import ModelNotAvailable
from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
from eioku_tpu_torch.models.yolo.postprocess import detect
from eioku_tpu_torch.models.yolo.weights import load_yolo_checkpoint
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import compute_dtype, resolve_device

log = logging.getLogger(__name__)

INPUT_SIZE = 640


def letterbox_batch(frames: np.ndarray, valid: int, size: int = INPUT_SIZE
                    ) -> tuple[np.ndarray, float, tuple[int, int]]:
    """Resize a uint8 [B, H, W, 3] batch preserving aspect, pad to (size, size).
    Returns (batch, scale, (pad_x, pad_y)) for box un-mapping."""
    b, h, w, _ = frames.shape
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    out = np.full((b, size, size, 3), 114, dtype=np.uint8)
    for i in range(valid):
        resized = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_LINEAR)
        out[i, pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return out, scale, (pad_x, pad_y)


def check_supported(config: dict) -> None:
    """Raise ModelNotAvailable for detection options the port does not run."""
    if config.get("preprocess", "host") == "device":
        raise ModelNotAvailable("object detection preprocess='device' is not "
                                "ported to eioku_tpu_torch")
    if config.get("int8"):
        raise ModelNotAvailable("int8 detection is not ported to eioku_tpu_torch")
    if config.get("data_parallel", "auto") is True:
        raise ModelNotAvailable("data-parallel detection is not ported to "
                                "eioku_tpu_torch (single device only)")


@lru_cache(maxsize=4)
def _load_model(model_name: str, num_classes: int, cache_dir: str | None,
                device: torch.device) -> YOLOv8:
    """Checkpoint, else random init (seed 0), then BN fold; on `device` in
    its compute type, in eval mode."""
    cfg = YoloConfig(variant=model_name.replace("-face", ""),
                     num_classes=num_classes)
    ckpt = os.path.join(cache_dir, f"{model_name}.pt") if cache_dir else None
    if ckpt and os.path.isfile(ckpt):
        model = load_yolo_checkpoint(ckpt, cfg)
        log.info("loaded yolo checkpoint", extra={"model": model_name,
                                                  "path": ckpt})
    else:
        model = YOLOv8(cfg, generator=torch.Generator().manual_seed(0))
        log.warning("no checkpoint found; using random-init weights",
                    extra={"model": model_name, "cache_dir": cache_dir})
    fold_batchnorm(model)
    return model.to(device=device, dtype=compute_dtype(device)).eval()


def emit_boxes(sink: list, out_np, meta, scale: float, pads, valid: int,
               coord_scale: float, src_wh: tuple[int, int], frame_ms: int,
               class_names) -> None:
    """Un-letterbox, clip and build object payloads for one fetched batch.
    meta[i] = (frame_number, t_ms) of batch slot i."""
    pad_x, pad_y = pads
    src_w, src_h = src_wh
    boxes, scores, classes, ok = out_np
    for i in range(valid):
        frame_idx, t_ms = meta[i]
        for j in np.nonzero(ok[i])[0]:
            x1, y1, x2, y2 = boxes[i, j]
            x1 = float(np.clip((x1 - pad_x) / scale * coord_scale, 0, src_w))
            x2 = float(np.clip((x2 - pad_x) / scale * coord_scale, 0, src_w))
            y1 = float(np.clip((y1 - pad_y) / scale * coord_scale, 0, src_h))
            y2 = float(np.clip((y2 - pad_y) / scale * coord_scale, 0, src_h))
            if x2 <= x1 or y2 <= y1:
                continue
            sink.append({
                "payload": {"label": class_names[int(classes[i, j])],
                            "confidence": float(scores[i, j]),
                            "bounding_box": {"x": x1, "y": y1,
                                             "width": x2 - x1,
                                             "height": y2 - y1},
                            "frame_number": frame_idx},
                "span_start_ms": t_ms,
                "span_end_ms": t_ms + frame_ms,
            })


def fetch(out: dict) -> tuple[np.ndarray, ...]:
    """Device detect outputs -> host arrays (boxes, scores, classes, valid)."""
    return tuple(out[k].cpu().numpy()
                 for k in ("boxes", "scores", "classes", "valid"))


def run_object_detection(video_path: str, config: dict,
                         model_cache_dir: str | None = None,
                         device: str | torch.device | None = None) -> list[dict]:
    check_supported(config)
    dev = resolve_device(device)
    conf = float(config.get("confidence_threshold", 0.5))
    interval = float(config.get("frame_interval_s", 1.0))
    batch_size = int(config.get("batch_size", 32))
    top_k = int(config.get("top_k", 256))
    model = _load_model(config.get("model", "yolov8n"), len(COCO_CLASSES),
                        model_cache_dir, dev)
    info = video_io.probe(video_path)
    frame_ms = int(round(1000.0 / info.fps)) if info.fps else 33

    results: list[dict] = []
    for batch in video_io.prefetch(video_io.iter_frame_batches(
            video_path, batch_size=batch_size, frame_interval_s=interval,
            decode_threads=int(config.get("decode_threads", 4)),
            decode_procs=int(config.get("decode_procs", 0)),
            fast_level=int(config.get("decode_fast", 1)))):
        boxed, scale, pads = letterbox_batch(batch.frames, batch.valid)
        out = detect(model, torch.from_numpy(boxed).to(dev),
                     conf_threshold=conf, top_k=top_k)
        meta = [(int(batch.frame_indices[i]), int(batch.timestamps_ms[i]))
                for i in range(batch.valid)]
        emit_boxes(results, fetch(out), meta, scale, pads, batch.valid, 1.0,
                   (info.width, info.height), frame_ms, COCO_CLASSES)
        if info.duration_ms > 0 and batch.valid:
            progress.report(batch.timestamps_ms[batch.valid - 1]
                            / info.duration_ms)
    return results
