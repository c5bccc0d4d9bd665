"""Data-parallel batched inference over several devices (port of
eioku_tpu/parallel/inference.py).

The JAX package shards a batch over its local devices in one process and
lets XLA partition the program. The port's counterpart, in one process and
with no process group: one replica of the model per device, the batch
padded to a multiple of the device count, each device given its
contiguous share, and the outputs gathered on the first device. Each share
runs under `torch.cuda.device(d)`, because the hand-written kernels (K2 in
detect, K3 in MiniLM at S >= 512) launch on the current device's stream.
A device may be listed twice ([cuda:0, cuda:0] runs the split, a share per
entry and the gather on one card); its replica is then shared.
"""
from __future__ import annotations

import contextlib
import copy
import itertools

import torch

from eioku_tpu_torch.models.embed.minilm import minilm_embed
from eioku_tpu_torch.models.yolo.postprocess import detect


def pad_to_multiple(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Zero rows appended to x's batch up to a multiple of `multiple`;
    returns (x, the original batch size)."""
    b = x.shape[0]
    target = -(-b // multiple) * multiple
    if target != b:
        x = torch.cat([x, x.new_zeros((target - b,) + tuple(x.shape[1:]))])
    return x, b


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _replicas(model: torch.nn.Module, devices) -> list[torch.nn.Module]:
    """One replica per entry of `devices`: the model itself where it lies,
    a copy moved to each other device (one per device)."""
    home = next(itertools.chain(model.parameters(), model.buffers())).device
    by_device: dict[torch.device, torch.nn.Module] = {home: model}
    out = []
    for d in devices:
        if d not in by_device:
            by_device[d] = copy.deepcopy(model).to(d)
        out.append(by_device[d])
    return out


class _DataParallel:
    def __init__(self, model: torch.nn.Module, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices")
        self.replicas = _replicas(model, self.devices)

    def _shares(self, *tensors: torch.Tensor):
        """Pad each tensor to a multiple of the device count and yield, per
        device, (device, replica, its share of each tensor on that device)."""
        n = len(self.devices)
        padded = [pad_to_multiple(t, n)[0] for t in tensors]
        per = padded[0].shape[0] // n
        for i, (d, m) in enumerate(zip(self.devices, self.replicas)):
            with _on(d):
                yield d, m, [t[i * per:(i + 1) * per].to(d) for t in padded]


class DataParallelDetector(_DataParallel):
    """YOLO detection with the frame batch split over `devices`."""

    def __call__(self, frames: torch.Tensor, conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45, top_k: int = 256) -> dict:
        b = frames.shape[0]
        outs = []
        for d, model, (share,) in self._shares(frames):
            outs.append(detect(model, share, conf_threshold=conf_threshold,
                               iou_threshold=iou_threshold, top_k=top_k))
        first = self.devices[0]
        return {k: torch.cat([o[k].to(first) for o in outs])[:b] for k in outs[0]}


class DataParallelEmbedder(_DataParallel):
    """MiniLM embedding with the chunk batch split over `devices`; padded
    rows get an all-zero mask, which the model's pooling handles."""

    def __call__(self, token_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b = token_ids.shape[0]
        outs = [minilm_embed(model, ids, mask)
                for d, model, (ids, mask) in self._shares(token_ids, attention_mask)]
        first = self.devices[0]
        return torch.cat([o.to(first) for o in outs])[:b]
