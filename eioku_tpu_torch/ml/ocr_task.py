"""OCR pipeline: sampled frames -> CRAFT score maps -> host box extraction ->
batched CRNN recognition -> ocr.text rows (port of eioku_tpu/ml/ocr_task.py).

The dense score maps and the recognition logits come from the device at
fixed shapes; connected components over the maps and the variable-width
crops stay on the host, with crops bucketed to a few fixed widths
(CROP_WIDTHS) and padded with -1.0, so each recognition batch is the JAX
package's. Frames travel to the device as planar I420 and are converted and
normalised there. The host stages (`extract_quads`, `_order_quad`,
`warp_quad_crop`, `_bucket_width`, `detect_text_crops`,
`quad_to_source_polygon`) are copies of the JAX package's.

Both models run fp32 on `device`; on the card cuDNN's convolutions keep
PyTorch's default (TF32 allowed).
"""
from __future__ import annotations

import logging
from functools import lru_cache

import cv2
import numpy as np
import torch
from scipy import ndimage

from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.models.ocr.craft import CRAFT
from eioku_tpu_torch.models.ocr.crnn import CRNN, LATIN_CHARSET, ctc_greedy_decode
from eioku_tpu_torch.models.ocr.weights import load_ocr_checkpoints, recognizer_for_language
from eioku_tpu_torch.ops.colorspace import i420_to_rgb, to_i420
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

DETECT_H, DETECT_W = 384, 640  # /32-divisible CRAFT input
CROP_WIDTHS = (32, 64, 128, 256, 512)  # recognizer width buckets
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


@torch.no_grad()
def craft_scores_i420(craft: CRAFT, planes_u8: torch.Tensor) -> torch.Tensor:
    """CRAFT detection from planar I420 frames [B, H*3/2, W] uint8 on the
    model's device: the normalised fp32 input is built there, so the host
    ships 1.5 bytes a pixel instead of 12. -> maps [B, H/2, W/2, 2]."""
    rgb = i420_to_rgb(planes_u8)  # [B, H, W, 3] in [0, 1]
    mean = torch.from_numpy(_MEAN).to(rgb.device)
    std = torch.from_numpy(_STD).to(rgb.device)
    return craft(((rgb - mean) / std).permute(0, 3, 1, 2))


@lru_cache(maxsize=4)
def _models(cache_dir: str | None, recognizer: str, device: torch.device):
    """(craft, crnn, charset, pretrained?), the models fp32 on `device`."""
    craft, crnn, charset, pretrained = load_ocr_checkpoints(cache_dir, recognizer)
    if not pretrained:
        log.warning("no easyocr checkpoints; OCR runs with random-init weights")
    return craft.to(device), crnn.to(device), charset, pretrained


def extract_boxes(region: np.ndarray, affinity: np.ndarray,
                  text_threshold: float = 0.7, low_text: float = 0.4,
                  link_threshold: float = 0.4, min_area: int = 10
                  ) -> list[tuple[int, int, int, int]]:
    """CRAFT-style box extraction: threshold region+affinity, connected
    components, keep components containing a confident text pixel.
    Returns (x0, y0, x1, y1) in score-map coordinates."""
    return [b for b, _ in extract_quads(region, affinity, text_threshold,
                                        low_text, link_threshold, min_area)]


def extract_quads(region: np.ndarray, affinity: np.ndarray,
                  text_threshold: float = 0.7, low_text: float = 0.4,
                  link_threshold: float = 0.4, min_area: int = 10
                  ) -> list[tuple[tuple[int, int, int, int], np.ndarray]]:
    """Like extract_boxes but each component also yields its minimum-area
    rotated quad (cv2.minAreaRect corner points, float32 [4, 2]) — the shape
    EasyOCR's CRAFT post-processing reports for slanted text
    (reference consumes those polygons, model_manager.py:469-558)."""
    text_mask = region >= low_text
    link_mask = affinity >= link_threshold
    combined = text_mask | link_mask
    labels, n = ndimage.label(combined)
    out = []
    for i in range(1, n + 1):
        ys, xs = np.nonzero(labels == i)
        if len(ys) < min_area:
            continue
        if region[ys, xs].max() < text_threshold:
            continue
        bbox = (int(xs.min()), int(ys.min()), int(xs.max()) + 1,
                int(ys.max()) + 1)
        pts = np.stack([xs, ys], axis=1).astype(np.float32)
        quad = cv2.boxPoints(cv2.minAreaRect(pts))  # [4, 2] float32
        out.append((bbox, quad))
    return out


def _order_quad(quad: np.ndarray) -> np.ndarray:
    """Order quad corners tl, tr, br, bl for perspective warping."""
    s = quad.sum(axis=1)
    d = quad[:, 0] - quad[:, 1]
    tl = quad[np.argmin(s)]
    br = quad[np.argmax(s)]
    tr = quad[np.argmax(d)]
    bl = quad[np.argmin(d)]
    return np.stack([tl, tr, br, bl]).astype(np.float32)


def warp_quad_crop(gray: np.ndarray, quad: np.ndarray,
                   min_rotation_px: float = 2.0) -> np.ndarray | None:
    """Rectify a rotated text quad to a horizontal strip (EasyOCR warps
    slanted detections before recognition). quad is in the same pixel space
    as `gray`. Returns None when the quad is essentially axis-aligned (the
    plain slice crop is cheaper and identical)."""
    q = _order_quad(quad)
    tl, tr, br, bl = q
    w = max(float(np.linalg.norm(tr - tl)), float(np.linalg.norm(br - bl)))
    h = max(float(np.linalg.norm(bl - tl)), float(np.linalg.norm(br - tr)))
    if w < 2 or h < 2:
        return None
    # rotation = vertical deviation of the top edge
    if abs(float(tr[1] - tl[1])) < min_rotation_px:
        return None
    dst = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                   np.float32)
    m = cv2.getPerspectiveTransform(q, dst)
    return cv2.warpPerspective(gray, m, (int(round(w)), int(round(h))))


def _bucket_width(w: int) -> int:
    for b in CROP_WIDTHS:
        if w <= b:
            return b
    return CROP_WIDTHS[-1]


def crop_batch(crops: list[np.ndarray], bucket: int) -> np.ndarray:
    """Grayscale uint8 [32, W] crops -> one recognizer batch [n, 1, 32,
    bucket] in [-1, 1], padded with -1.0 (the JAX package's [n, 32, bucket,
    1] batch, channels first)."""
    batch = np.full((len(crops), 1, 32, bucket), -1.0, np.float32)
    for row, c in enumerate(crops):
        if c.shape[1] > bucket:
            # wider than the largest bucket: squeeze to fit — truncation
            # would silently drop the trailing characters of long lines
            c = cv2.resize(c, (bucket, 32))
        w = c.shape[1]
        resized = c if c.shape[0] == 32 else cv2.resize(c, (w, 32))
        batch[row, 0, :, :w] = resized.astype(np.float32) / 127.5 - 1.0
    return batch


@torch.no_grad()
def recognize_crops(crnn: CRNN, crops: list[np.ndarray],
                    charset: str = LATIN_CHARSET) -> list[tuple[str, float]]:
    """crops: list of grayscale uint8 [32, W]. Returns (text, conf) per crop,
    batched per width bucket (fixed shapes on the device)."""
    dev = next(crnn.parameters()).device
    results: list[tuple[str, float] | None] = [None] * len(crops)
    by_bucket: dict[int, list[int]] = {}
    for i, c in enumerate(crops):
        by_bucket.setdefault(_bucket_width(c.shape[1]), []).append(i)
    for bucket, indices in by_bucket.items():
        batch = crop_batch([crops[i] for i in indices], bucket)
        logits = crnn(torch.from_numpy(batch).to(dev)).float().cpu().numpy()
        for row, i in enumerate(indices):
            results[i] = ctc_greedy_decode(logits[row:row + 1], charset)[0]
    return results  # type: ignore[return-value]


def detect_text_crops(gray: np.ndarray, region: np.ndarray,
                      affinity: np.ndarray
                      ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Quads -> rectified 32-px-high crops for ONE frame at detector geometry.

    `gray` is the detector-input grayscale frame; region/affinity are the
    CRAFT score maps (half detector resolution). Returns (crops, quads) with
    quads in detector-input coordinates — the shared front half of the
    standalone task and the combined-pass OCR consumer.
    """
    import cv2

    quads = extract_quads(region, affinity)
    crops: list[np.ndarray] = []
    metas: list[np.ndarray] = []
    for (x0, y0, x1, y1), quad in quads:
        # slanted text: rectify along the minAreaRect quad before
        # recognition (EasyOCR's warp); axis-aligned uses the slice
        crop = warp_quad_crop(gray, quad * 2.0)
        if crop is None:
            crop = gray[y0 * 2:y1 * 2, x0 * 2:x1 * 2]
        if crop.size == 0:
            continue
        h, w = crop.shape
        crops.append(cv2.resize(crop, (max(int(w * 32.0 / h), 8), 32)))
        metas.append(quad * 2.0)  # detector-input coords
    return crops, metas


def quad_to_source_polygon(quad: np.ndarray, sx: float, sy: float
                           ) -> list[list[float]]:
    """Detector-input quad -> clipped source-pixel polygon payload (the
    reference's easyocr emits rotated quads; minAreaRect corners can poke
    past the frame, so clip at 0)."""
    return [[float(max(px * sx, 0.0)), float(max(py * sy, 0.0))]
            for px, py in quad]


def ocr_rows(texts, metas, min_conf: float, sx: float, sy: float,
             languages: list[str], frame_index: int, t_ms: int,
             frame_ms: int) -> list[dict]:
    """ocr.text rows of one frame: one per recognized crop with text and
    confidence not below min_conf; the one row shape of the standalone task and the
    combined pass."""
    return [{"payload": {"text": text, "confidence": min(conf, 1.0),
                         "polygon": quad_to_source_polygon(quad, sx, sy),
                         "languages": languages, "frame_index": frame_index},
             "span_start_ms": t_ms, "span_end_ms": t_ms + frame_ms}
            for quad, (text, conf) in zip(metas, texts)
            if text and not conf < min_conf]


def run_ocr(video_path: str, config: dict, model_cache_dir: str | None = None,
            device: str | torch.device | None = None) -> list[dict]:
    dev = resolve_device(device)
    interval = float(config.get("frame_interval_s", 2.0))
    batch_size = int(config.get("batch_size", 16))
    languages = config.get("languages") or ([config["language"]]
                                            if config.get("language") else ["en"])
    min_conf = float(config.get("confidence_threshold", 0.0))
    # one recognizer per task: discovery fans OCR out per language, so the
    # task's first language picks the script-specific model
    recognizer = recognizer_for_language(languages[0])
    craft, crnn, charset, _ = _models(model_cache_dir, recognizer, dev)
    info = video_io.probe(video_path)
    frame_ms = int(round(1000.0 / info.fps)) if info.fps else 33
    sx = info.width / DETECT_W   # detector-input coords -> source pixels
    sy = info.height / DETECT_H

    results: list[dict] = []
    for batch in video_io.prefetch(video_io.iter_frame_batches(
            video_path, batch_size=batch_size, frame_interval_s=interval,
            resize_hw=(DETECT_H, DETECT_W),
            decode_threads=int(config.get("decode_threads", 4)),
            decode_procs=int(config.get("decode_procs", 0)),
            fast_level=int(config.get("decode_fast", 1)))):
        scores = craft_scores_i420(
            craft, torch.from_numpy(to_i420(batch.frames)).to(dev)).cpu().numpy()
        for i in range(batch.valid):
            gray = cv2.cvtColor(batch.frames[i], cv2.COLOR_RGB2GRAY)
            crops, metas = detect_text_crops(gray, scores[i, :, :, 0],
                                             scores[i, :, :, 1])
            if not crops:
                continue
            results.extend(ocr_rows(
                recognize_crops(crnn, crops, charset), metas, min_conf, sx, sy,
                languages, int(batch.frame_indices[i]),
                int(batch.timestamps_ms[i]), frame_ms))
        if info.duration_ms > 0 and batch.valid:
            progress.report(batch.timestamps_ms[batch.valid - 1]
                            / info.duration_ms)
    return results
