"""Object and face detection over batched video frames (port of
eioku_tpu/ml/detection.py).

Objects: yolov8n, conf 0.5, every 1 s. Faces: yolov8n-face (one class), conf
0.7, every 3 s, label "face", a cluster id from cross-frame IoU tracking and,
with {"embeddings": true}, an L2-normalised ArcFace identity embedding per
face. Frames are letterboxed into fixed 640x640 batches and the whole
forward + decode + top-K + NMS graph runs on the device per batch; boxes are
un-letterboxed back to source pixels on the host.

Options, as in the JAX package: `preprocess` "host" (cv2 letterbox in the
decode thread, the default) or "device" (ops/resize.py's interpolation
products on the device, fp32 frames in [0, 1]); `int8` (per-output-channel
int8 conv weights, dynamic per-image activation scales: ops/quant.py);
`data_parallel` "auto" (the default: split each batch over the visible
cards when there is more than one), true (over every visible card, so one
card on a one-card host) or false (the plain path).

Checkpoints: `{model}.pt` (ultralytics format) and `arcface_r18.pth`
(insightface layout) under model_cache_dir, else random-init weights from a
seeded `torch.Generator` with a warning, so the pipeline stays runnable
without downloads.
"""
from __future__ import annotations

import logging
import os
from functools import lru_cache

import cv2
import numpy as np
import torch

from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.models.layers import quantize_convs
from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
from eioku_tpu_torch.models.yolo.postprocess import detect
from eioku_tpu_torch.models.yolo.weights import load_yolo_checkpoint
from eioku_tpu_torch.ops.resize import letterbox_geometry, letterbox_resize_normalize
from eioku_tpu_torch.parallel.inference import DataParallelDetector
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


@lru_cache(maxsize=8)
def _load_model(model_name: str, num_classes: int, cache_dir: str | None,
                device: torch.device, int8: bool = False) -> YOLOv8:
    """Checkpoint, else random init (seed 0), then BN fold and, with int8,
    the convs quantized from the fp32 weights (as the JAX package quantizes
    its fp32 tree); on `device` in its compute type, in eval mode."""
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
    if int8:
        # an opt-in for the weights' memory, as in the JAX package: it halves
        # them; each conv runs slower than bf16 on the card, and the task's
        # peak memory stands beside bf16's in PERF.md
        quantize_convs(model)
        log.info("int8-quantized detector", extra={"model": model_name})
    return model.to(device=device, dtype=compute_dtype(device)).eval()


def data_parallel_devices(device: torch.device) -> list[torch.device]:
    """Every visible card for a CUDA device, else the device itself."""
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@lru_cache(maxsize=4)
def _dp_detector(model_name: str, num_classes: int, cache_dir: str | None,
                 device: torch.device, int8: bool = False) -> DataParallelDetector:
    """A DataParallelDetector over every visible card (or `device` itself
    off the card)."""
    return DataParallelDetector(
        _load_model(model_name, num_classes, cache_dir, device, int8),
        data_parallel_devices(device))


def object_payload(label: str, conf: float, box: dict, frame: int) -> dict:
    return {"label": label, "confidence": conf, "bounding_box": box,
            "frame_number": frame}


def face_payload(label: str, conf: float, box: dict, frame: int) -> dict:
    return {"cluster_id": None, "confidence": conf, "bounding_box": box,
            "frame_number": frame}


def emit_boxes(sink: list, out_np, meta, scale: float, pads, valid: int,
               coord_scale: float, src_wh: tuple[int, int], frame_ms: int,
               class_names, payload_builder=object_payload) -> None:
    """Un-letterbox, clip and build payloads for one fetched batch. meta[i] =
    (frame_number, t_ms) of batch slot i; the label is "face" when there are
    no class names."""
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
            label = class_names[int(classes[i, j])] if class_names else "face"
            sink.append({
                "payload": payload_builder(
                    label, float(scores[i, j]),
                    {"x": x1, "y": y1, "width": x2 - x1, "height": y2 - y1},
                    frame_idx),
                "span_start_ms": t_ms,
                "span_end_ms": t_ms + frame_ms,
            })


def fetch(out: dict) -> tuple[np.ndarray, ...]:
    """Device detect outputs -> host arrays (boxes, scores, classes, valid)."""
    return tuple(out[k].cpu().numpy()
                 for k in ("boxes", "scores", "classes", "valid"))


def _run_detection(video_path: str, config: dict, *, model_name: str,
                   num_classes: int, class_names: list[str],
                   default_conf: float, default_interval: float,
                   model_cache_dir: str | None, payload_builder,
                   device: torch.device, batch_hook=None) -> list[dict]:
    """The detection task loop shared by objects and faces. batch_hook(batch,
    rows) runs after each batch's rows are built, while its decoded frames
    are still in memory."""
    conf = float(config.get("confidence_threshold", default_conf))
    interval = float(config.get("frame_interval_s", default_interval))
    batch_size = int(config.get("batch_size", 32))
    top_k = int(config.get("top_k", 256))
    preprocess = config.get("preprocess", "host")
    int8 = bool(config.get("int8", False))
    model = _load_model(model_name, num_classes, model_cache_dir, device, int8)
    dp_mode = config.get("data_parallel", "auto")
    use_dp = len(data_parallel_devices(device)) > 1 if dp_mode == "auto" \
        else bool(dp_mode)
    dp = _dp_detector(model_name, num_classes, model_cache_dir, device, int8) \
        if use_dp else None
    info = video_io.probe(video_path)
    frame_ms = int(round(1000.0 / info.fps)) if info.fps else 33

    results: list[dict] = []
    for batch in video_io.prefetch(video_io.iter_frame_batches(
            video_path, batch_size=batch_size, frame_interval_s=interval,
            decode_threads=int(config.get("decode_threads", 4)),
            decode_procs=int(config.get("decode_procs", 0)),
            fast_level=int(config.get("decode_fast", 1)))):
        batch_start = len(results)
        if preprocess == "device":
            scale, pad_x, pad_y = letterbox_geometry(
                batch.frames.shape[1], batch.frames.shape[2], INPUT_SIZE)
            pads = (pad_x, pad_y)
            boxed = letterbox_resize_normalize(
                torch.from_numpy(batch.frames).to(device), INPUT_SIZE, INPUT_SIZE)
        else:
            boxed, scale, pads = letterbox_batch(batch.frames, batch.valid)
            boxed = torch.from_numpy(boxed).to(device)
        if dp is not None:
            out = dp(boxed, conf_threshold=conf, top_k=top_k)
        else:
            out = detect(model, boxed, conf_threshold=conf, top_k=top_k)
        meta = [(int(batch.frame_indices[i]), int(batch.timestamps_ms[i]))
                for i in range(batch.valid)]
        emit_boxes(results, fetch(out), meta, scale, pads, batch.valid, 1.0,
                   (info.width, info.height), frame_ms, class_names,
                   payload_builder)
        if batch_hook is not None:
            batch_hook(batch, results[batch_start:])
        if info.duration_ms > 0 and batch.valid:
            progress.report(batch.timestamps_ms[batch.valid - 1]
                            / info.duration_ms)
    return results


def run_object_detection(video_path: str, config: dict,
                         model_cache_dir: str | None = None,
                         device: str | torch.device | None = None) -> list[dict]:
    return _run_detection(
        video_path, config, model_name=config.get("model", "yolov8n"),
        num_classes=len(COCO_CLASSES), class_names=COCO_CLASSES,
        default_conf=0.5, default_interval=1.0, model_cache_dir=model_cache_dir,
        payload_builder=object_payload, device=resolve_device(device))


def run_face_detection(video_path: str, config: dict,
                       model_cache_dir: str | None = None,
                       device: str | torch.device | None = None) -> list[dict]:
    """{"embeddings": true}: ArcFace identity embeddings per face, cropped
    from the decoded frames in the same pass (no second decode)."""
    dev = resolve_device(device)
    collector = _FaceCropCollector(dev) if config.get("embeddings") else None
    results = _run_detection(
        video_path, config, model_name=config.get("model", "yolov8n-face"),
        num_classes=1, class_names=[], default_conf=0.7, default_interval=3.0,
        model_cache_dir=model_cache_dir, payload_builder=face_payload,
        device=dev, batch_hook=collector.collect if collector else None)
    _assign_face_clusters(results)
    if collector:
        collector.attach_embeddings(model_cache_dir)
    return results


class _FaceCropCollector:
    """Crops face boxes from each decoded batch, then embeds all crops with
    the ArcFace model (fp32) and writes payload.embedding: L2-normalised, so
    People clustering works in plain cosine space, rounded to 5 places."""

    EMBED_BATCH = 64

    def __init__(self, device: torch.device):
        from eioku_tpu_torch.models.face_embed.model import INPUT_SIZE as FACE_SIZE

        self.device = device
        self.size = FACE_SIZE
        self.crops: list[np.ndarray] = []
        self.payloads: list[dict] = []

    def collect(self, batch, batch_results: list[dict]) -> None:
        local = {int(f): i for i, f in
                 enumerate(batch.frame_indices[:batch.valid])}
        for r in batch_results:
            p = r["payload"]
            i = local.get(p["frame_number"])
            if i is None:
                continue
            b = p["bounding_box"]
            x1, y1 = int(b["x"]), int(b["y"])
            x2, y2 = int(b["x"] + b["width"]), int(b["y"] + b["height"])
            crop = batch.frames[i, max(y1, 0):max(y2, 1), max(x1, 0):max(x2, 1)]
            if crop.size == 0:
                continue
            self.crops.append(cv2.resize(crop, (self.size, self.size),
                                         interpolation=cv2.INTER_LINEAR))
            self.payloads.append(p)

    @torch.no_grad()
    def attach_embeddings(self, model_cache_dir: str | None) -> None:
        if not self.crops:
            return
        from eioku_tpu_torch.models.face_embed.model import preprocess

        model = _load_face_embedder(model_cache_dir, self.device)
        crops = preprocess(np.stack(self.crops))
        vecs = []
        bs = self.EMBED_BATCH
        for i in range(0, len(crops), bs):
            chunk = crops[i:i + bs]
            n = len(chunk)
            if n < bs:  # one fixed batch shape
                chunk = np.concatenate(
                    [chunk, np.zeros((bs - n,) + chunk.shape[1:], np.float32)])
            x = torch.from_numpy(chunk).to(self.device).permute(0, 3, 1, 2)
            vecs.append(model(x)[:n].cpu().numpy())
        emb = np.concatenate(vecs).astype(np.float32)
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        for p, v in zip(self.payloads, emb):
            p["embedding"] = [round(float(x), 5) for x in v]


def attach_face_embeddings(video_path: str, results: list[dict],
                           frame_step: int,
                           model_cache_dir: str | None = None,
                           device: str | torch.device | None = None,
                           batch_size: int = 32) -> None:
    """The {"embeddings": true} path for pipelines that no longer hold the
    decoded frames (the combined visual pass): re-decode on the EXACT
    sampling grid the faces came from and crop the boxes whose frame numbers
    match. frame_step is the caller's true source-frames-per-sample (the
    combined pass's face step, snapped to its base grid); re-deriving a grid
    from a seconds interval here would round differently and miss every face
    off the re-derived grid."""
    if not results:
        return
    info = video_io.probe(video_path)
    fps = info.fps or 30.0
    by_frame: dict[int, list[dict]] = {}
    for r in results:
        by_frame.setdefault(r["payload"]["frame_number"], []).append(r)
    collector = _FaceCropCollector(resolve_device(device))
    matched_frames: set[int] = set()
    # iter_frame_batches recomputes step = round(fps * interval); feeding
    # frame_step / fps back through that is an exact round trip
    for batch in video_io.iter_frame_batches(
            video_path, batch_size=batch_size,
            frame_interval_s=max(frame_step, 1) / fps):
        frames = [int(f) for f in batch.frame_indices[:batch.valid]]
        matched = [r for f in frames for r in by_frame.get(f, [])]
        matched_frames.update(f for f in frames if f in by_frame)
        if matched:
            collector.collect(batch, matched)
    missed = set(by_frame) - matched_frames
    if missed:
        log.warning("face embedding re-decode missed %d/%d face frames "
                    "(frame_step=%d mismatch?)", len(missed), len(by_frame),
                    frame_step)
    collector.attach_embeddings(model_cache_dir)


@lru_cache(maxsize=2)
def _load_face_embedder(model_cache_dir: str | None, device: torch.device):
    """The ArcFace model on `device`, fp32, in eval mode."""
    from eioku_tpu_torch.models.face_embed.model import load_face_embed

    model, pretrained = load_face_embed(model_cache_dir)
    if not pretrained:
        log.warning("no arcface_r18 checkpoint; face embeddings are "
                    "random-init (clustering quality will be poor)")
    return model.to(device=device, dtype=torch.float32).eval()


def _assign_face_clusters(results: list[dict],
                          frame_step: int | None = None) -> None:
    """Cross-frame IoU tracking -> cluster ids (ml/face_tracking.py).

    frame_step: source frames per sample; estimated from the detection frame
    numbers when not provided (frames with no faces never reach the tracker,
    so gaps must be measured in source-frame distance)."""
    from eioku_tpu_torch.ml.face_tracking import FaceTracker

    frames = sorted({r["payload"]["frame_number"] for r in results})
    if frame_step is None:
        diffs = [b - a for a, b in zip(frames, frames[1:]) if b > a]
        frame_step = min(diffs) if diffs else 1
    tracker = FaceTracker(frame_step=max(frame_step, 1))
    by_frame: dict[int, list[dict]] = {}
    for r in results:
        by_frame.setdefault(r["payload"]["frame_number"], []).append(r)
    for frame in frames:
        group = by_frame[frame]
        ids = tracker.assign([r["payload"]["bounding_box"] for r in group],
                             frame_index=frame)
        for r, cid in zip(group, ids):
            r["payload"]["cluster_id"] = cid
