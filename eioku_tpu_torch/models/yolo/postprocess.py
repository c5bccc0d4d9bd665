"""YOLO head decoding, top-K and NMS (port of eioku_tpu/models/yolo/postprocess.py).

Everything stays fixed-shape on the device: select the top-K candidates by
score, compute the greedy NMS keep mask (ops/nms.py; the CUDA kernel on the
card), and emit a fixed number of slots with a validity mask; the host trims.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from eioku_tpu_torch.models.yolo.model import YOLOv8, anchor_points
from eioku_tpu_torch.ops.nms import nms_keep_mask


def decode_boxes(box_logits: torch.Tensor, anchors: torch.Tensor,
                 strides: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """DFL decode: box_logits [B, A, 4*reg_max] -> xyxy pixels [B, A, 4],
    in float32 whatever the logits' type."""
    b, a, _ = box_logits.shape
    dist = box_logits.reshape(b, a, 4, reg_max).float()
    bins = torch.arange(reg_max, dtype=torch.float32, device=dist.device)
    e = torch.exp(dist - torch.amax(dist, dim=-1, keepdim=True))
    ltrb = torch.einsum("bafr,r->baf", e, bins) / torch.sum(e, dim=-1)
    ltrb = ltrb * strides[None, :, None]
    x1y1 = anchors[None] - ltrb[..., :2]
    x2y2 = anchors[None] + ltrb[..., 2:]
    return torch.cat([x1y1, x2y2], dim=-1)


def _kept_slots(keep: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor) -> dict:
    return {
        "boxes": boxes,
        "scores": torch.where(keep, scores, torch.zeros_like(scores)),
        "classes": torch.where(keep, classes, torch.full_like(classes, -1)),
        "valid": keep,
    }


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
              iou_threshold: float = 0.45, max_det: int = 300) -> dict:
    """Greedy class-aware NMS over score-sorted candidates, batched.

    boxes [B, K, 4], scores [B, K] (0 for padding), classes [B, K]. Returns
    fixed-shape [B, min(K, max_det)] slots: boxes, scores, classes, valid.
    When K <= max_det the slots stay in score order with suppressed slots
    masked out; only the K > max_det truncation reorders kept boxes to the
    front (a stable sort, so score order survives). Consumers trim by the
    `valid` mask, never by slot position."""
    keep = nms_keep_mask(boxes, scores, classes, iou_threshold)
    if boxes.shape[1] <= max_det:
        return _kept_slots(keep, boxes, scores, classes)
    # kept first, score order preserved; torch.sort has no bool kernel
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    sel = order[:, :max_det]
    return _kept_slots(
        torch.gather(keep, 1, sel),
        torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4)),
        torch.gather(scores, 1, sel), torch.gather(classes, 1, sel))


def pad_offsets_for(h: int, w: int) -> tuple[int, int]:
    """(pad_x, pad_y) that detect() applies to align (h, w) to stride 32."""
    return ((-w) % 32) // 2, ((-h) % 32) // 2


@torch.no_grad()
def detect(model: YOLOv8, images: torch.Tensor, conf_threshold: float = 0.25,
           iou_threshold: float = 0.45, top_k: int = 256,
           max_det: int = 300) -> dict:
    """Batched detection: forward -> decode -> top-K -> NMS, on the images'
    device.

    images: [B, H, W, 3] (NHWC, as in the JAX package) uint8, or float in
    [0, 1]; they run in the model's parameter type. Returns a dict of
    [B, min(top_k, max_det), ...] fixed-shape outputs plus the validity mask.
    """
    dtype = model.dtype
    x = images.to(dtype) / 255.0 if images.dtype == torch.uint8 \
        else images.to(dtype)
    b, h, w, _ = x.shape
    x = x.permute(0, 3, 1, 2)
    if h % 32 or w % 32:
        # pad to stride alignment on the device (letterbox gray), centred;
        # callers account for the offset via pad_offsets_for()
        ph, pw = (-h) % 32, (-w) % 32
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                  value=114.0 / 255.0)
        h, w = h + ph, w + pw
    box_logits, cls_logits = model(x)
    anchors, strides = anchor_points(h, w, model.cfg.strides, x.device)
    boxes = decode_boxes(box_logits, anchors, strides, model.cfg.reg_max)
    # sigmoid is monotonic: max/argmax over raw logits give the same class
    # and score as over probabilities
    scores_all = torch.sigmoid(torch.amax(cls_logits, dim=-1).float())  # [B, A]
    classes_all = torch.argmax(cls_logits, dim=-1).to(torch.int32)  # first max
    scores_all = torch.where(scores_all >= conf_threshold, scores_all,
                             torch.zeros_like(scores_all))

    k = min(top_k, scores_all.shape[1])
    # a stable descending sort breaks ties (many exact zeros) by lower index,
    # as jax.lax.top_k does; torch.topk promises no tie order
    top_scores, top_idx = torch.sort(scores_all, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes_all, 1, top_idx)
    return nms_fixed(top_boxes, top_scores, top_classes, iou_threshold, max_det)
