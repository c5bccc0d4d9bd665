"""Batched exact greedy NMS keep mask.

Port of eioku_tpu/ops/nms.py. On a CUDA tensor `nms_keep_mask` launches the
hand-written kernel csrc/nms.cu (it replaces the Pallas `_nms_kernel` and
serves every K up to MAX_CANDIDATES, so detect() has one NMS for both of its
routes: a suppression bitmask, then a one-warp scan word by word); on a CPU
tensor it runs `nms_keep_mask_plain`, which mirrors the JAX package's Jacobi
fixpoint (`nms_fixed`, `_reference_keep`): keep = valid and no kept
higher-ranked same-class box has IoU > threshold, iterated from `valid` until
it stops changing. Both give the unique greedy solution.
"""
from __future__ import annotations

import torch

from eioku_tpu_torch.ops import _cuda

MAX_CANDIDATES = 10_240  # csrc/nms.cu kMaxK: five removed words per scan lane
_WORD = 64  # ranks per bitmask word


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU for [..., K, 4] xyxy boxes -> [..., K, K], rounded exactly
    as eioku_tpu/models/yolo/postprocess.py `_iou_matrix` rounds it."""
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_keep_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                        classes: torch.Tensor,
                        iou_threshold: float = 0.45) -> torch.Tensor:
    """Jacobi form: boxes [B, K, 4], scores [B, K] (0 = padding), classes
    [B, K] -> keep [B, K] bool. Candidates must be sorted by score."""
    k = boxes.shape[1]
    iou = iou_matrix(boxes.float())
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    same = classes[:, :, None] == classes[:, None, :]
    ranks = torch.arange(k, device=boxes.device)
    # conflict[b, j, i]: higher-ranked j (j < i) suppresses i
    conflict = ((iou > thr) & same & (ranks[:, None] < ranks[None, :])).float()
    valid = scores > 0
    keep = valid
    for _ in range(k):
        counts = torch.einsum("bji,bj->bi", conflict, keep.float())
        new = valid & (counts < 0.5)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  classes: torch.Tensor,
                  iou_threshold: float = 0.45) -> torch.Tensor:
    """Exact greedy-NMS keep mask for score-sorted candidates.

    boxes [B, K, 4] xyxy; scores [B, K] (0 = padding); classes [B, K].
    Returns keep [B, K] bool. CPU tensors take the plain version; CUDA
    tensors launch the kernel (there is no fallback on the card)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, K, 4], got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if scores.shape != (b, k) or classes.shape != (b, k):
        raise ValueError("scores and classes must be [B, K] like boxes")
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, scores, classes, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if scores.device != boxes.device or classes.device != boxes.device:
        raise ValueError("boxes, scores and classes must be on one device")
    if k > MAX_CANDIDATES:
        raise ValueError(f"the nms kernel takes at most {MAX_CANDIDATES} "
                         f"candidates per image, got K={k}")
    # convert only where needed: a no-op conversion still costs ~2 us of
    # host time a call, and the wrapper's host time exceeds the kernel's
    if boxes.dtype != torch.float32 or not boxes.is_contiguous():
        boxes = boxes.to(torch.float32).contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads boxes as float4
        boxes = boxes.clone()
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        scores = scores.to(torch.float32).contiguous()
    if classes.dtype != torch.int32 or not classes.is_contiguous():
        classes = classes.to(torch.int32).contiguous()
    keep = torch.empty((b, k), dtype=torch.uint8, device=boxes.device)
    # the kernel's bitmask (W words of 64 W rows per image) and validity words
    words = -(-k // _WORD)
    scratch = torch.empty(b * words * (_WORD * words + 1), dtype=torch.int64,
                          device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    _cuda.launch("nms", "eioku_nms_keep", boxes.data_ptr(), scores.data_ptr(),
                 classes.data_ptr(), keep.data_ptr(), scratch.data_ptr(), b, k,
                 float(iou_threshold), stream)
    return keep.view(torch.bool)
