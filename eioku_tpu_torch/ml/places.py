"""Place classification: sampled frames -> ResNet18-Places365 top-k (port of
eioku_tpu/ml/places.py).

Frames decode at 224x224 (host resize), go to the device as uint8, are
normalised there and classified in batches; the softmax runs in fp32 and the
top-k comes from a stable descending sort, so equal probabilities keep the
lower class index first (as jax.lax.top_k does; torch.topk promises no tie
order). One result per sampled frame.
"""
from __future__ import annotations

import logging
from functools import lru_cache

import torch

from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.models.resnet.model import (
    INPUT_SIZE,
    ResNet18,
    load_places365,
    preprocess,
)
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import compute_dtype, resolve_device

log = logging.getLogger(__name__)


@lru_cache(maxsize=2)
def _model(cache_dir: str | None, device: torch.device) -> tuple[ResNet18, list[str]]:
    """(model on `device` in its compute type, in eval mode; labels)."""
    model, labels, pretrained = load_places365(cache_dir)
    if not pretrained:
        log.warning("no places365 checkpoint; using random-init weights")
    return model.to(device=device, dtype=compute_dtype(device)).eval(), labels


@torch.no_grad()
def classify(model: ResNet18, x: torch.Tensor, top_k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """ImageNet-normalised fp32 [B, 3, 224, 224] (`normalize`, `preprocess`)
    -> (probabilities, class indices), each [B, top_k], highest first. The
    trunk runs in the model's type, the softmax in fp32."""
    logits = model(x.to(next(model.parameters()).dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    scores, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return scores[:, :top_k], idx[:, :top_k]


def place_records(scores, idx, meta, valid: int, labels: list[str],
                  frame_ms: int) -> list[dict]:
    """place.classification rows from host top-k arrays; meta[i] =
    (frame_number, t_ms) of slot i. The one row shape of the standalone and
    combined paths."""
    recs = []
    for i in range(valid):
        fi, t_ms = meta[i]
        preds = [{"label": labels[int(idx[i, j])], "confidence": float(scores[i, j])}
                 for j in range(scores.shape[1])]
        recs.append({"payload": {"predictions": preds, "frame_number": fi},
                     "span_start_ms": t_ms, "span_end_ms": t_ms + frame_ms})
    return recs


def run_place_classification(video_path: str, config: dict,
                             model_cache_dir: str | None = None,
                             device: str | torch.device | None = None) -> list[dict]:
    dev = resolve_device(device)
    interval = float(config.get("frame_interval_s", 1.0))
    batch_size = int(config.get("batch_size", 64))
    top_k = int(config.get("top_k", 5))
    model, labels = _model(model_cache_dir, dev)
    info = video_io.probe(video_path)
    frame_ms = int(round(1000.0 / info.fps)) if info.fps else 33

    results: list[dict] = []
    for batch in video_io.prefetch(video_io.iter_frame_batches(
            video_path, batch_size=batch_size, frame_interval_s=interval,
            resize_hw=(INPUT_SIZE, INPUT_SIZE),
            decode_threads=int(config.get("decode_threads", 4)),
            decode_procs=int(config.get("decode_procs", 0)),
            fast_level=int(config.get("decode_fast", 1)))):
        scores, idx = classify(
            model, preprocess(torch.from_numpy(batch.frames).to(dev)), top_k)
        meta = [(int(batch.frame_indices[i]), int(batch.timestamps_ms[i]))
                for i in range(batch.valid)]
        results.extend(place_records(scores.cpu().numpy(), idx.cpu().numpy(),
                                     meta, batch.valid, labels, frame_ms))
        if info.duration_ms > 0 and batch.valid:
            progress.report(batch.timestamps_ms[batch.valid - 1]
                            / info.duration_ms)
    return results
