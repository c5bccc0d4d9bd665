"""Data-parallel batched inference over several devices (port of
eioku_tpu/parallel/inference.py).

The JAX package shards a batch over its mesh's data axis and lets XLA
partition the program. The port's counterpart: one replica of the model
per device of a data line (parallel/mesh.py, parallel/collectives.py), the
batch padded to a multiple of the line's size, each entry given its
contiguous share, and the outputs gathered over the line. In one process
(a device list, or a mesh without process groups) the gather lands on the
first device; over a mesh whose data axis spans a process group each rank
detects its share and every rank returns the whole result, as every JAX
host sees the global array. Each share runs under its device, because the
hand-written kernels (K2 in detect, K3 in MiniLM at S >= 512) launch on the
current device's stream. A device may be listed twice ([cuda:0, cuda:0]
runs the split, a share per entry and the gather on one card); its replica
is then shared.
"""
from __future__ import annotations

import copy
import itertools

import torch

from eioku_tpu_torch.models.embed.minilm import minilm_embed
from eioku_tpu_torch.models.yolo.postprocess import detect
from eioku_tpu_torch.parallel.collectives import LocalCollectives, on
from eioku_tpu_torch.parallel.mesh import Mesh


def pad_to_multiple(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Zero rows appended to x's batch up to a multiple of `multiple`;
    returns (x, the original batch size)."""
    b = x.shape[0]
    target = -(-b // multiple) * multiple
    if target != b:
        x = torch.cat([x, x.new_zeros((target - b,) + tuple(x.shape[1:]))])
    return x, b


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
    def __init__(self, model: torch.nn.Module, devices: list | Mesh):
        """devices: the devices of a line in this process, or a mesh whose
        data axis the batch splits over."""
        self.line = (devices.lines("data")[0] if isinstance(devices, Mesh)
                     else LocalCollectives(devices))
        self.devices = self.line.devices
        self.replicas = _replicas(model, self.devices)

    def _shares(self, *tensors: torch.Tensor):
        """Pad each tensor to a multiple of the line's size and yield, per
        local entry, (device, replica, its share of each tensor there)."""
        n = self.line.size
        padded = [pad_to_multiple(t, n)[0] for t in tensors]
        per = padded[0].shape[0] // n
        for i, d, m in zip(self.line.indices, self.devices, self.replicas):
            with on(d):
                yield d, m, [t[i * per:(i + 1) * per].to(d) for t in padded]

    def _gather(self, parts: list[torch.Tensor], b: int) -> torch.Tensor:
        """The local entries' outputs gathered over the line (bool as bytes,
        which every backend gathers), cut back to the batch's b rows."""
        flag = parts[0].dtype == torch.bool
        parts = [p.view(torch.uint8) if flag else p for p in parts]
        full = self.line.all_gather(parts, dim=0)[0][:b]
        return full.view(torch.bool) if flag else full


class DataParallelDetector(_DataParallel):
    """YOLO detection with the frame batch split over a data line."""

    def __call__(self, frames: torch.Tensor, conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45, top_k: int = 256) -> dict:
        outs = [detect(model, share, conf_threshold=conf_threshold,
                       iou_threshold=iou_threshold, top_k=top_k)
                for d, model, (share,) in self._shares(frames)]
        return {k: self._gather([o[k] for o in outs], frames.shape[0]) for k in outs[0]}


class DataParallelEmbedder(_DataParallel):
    """MiniLM embedding with the chunk batch split over a data line; padded
    rows get an all-zero mask, which the model's pooling handles."""

    def __call__(self, token_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        outs = [minilm_embed(model, ids, mask)
                for d, model, (ids, mask) in self._shares(token_ids, attention_mask)]
        return self._gather(outs, token_ids.shape[0])
