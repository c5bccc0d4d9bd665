"""Pairwise frame-difference scoring, the scene-detection hot loop.

Port of eioku_tpu/ops/scene_diff.py. score[i] = mean |hsv[i] - hsv[i-1]| over
all pixels and channels, in [0, 1], with the previous batch's last plane
prepended so a whole video is scored chunk by chunk without a host round trip.

On a CUDA tensor `pair_diff` launches the hand-written kernel
csrc/scene_diff.cu (it replaces the Pallas `_diff_kernel`); on a CPU tensor it
runs `pair_diff_plain`, the plain PyTorch version of the same function.
"""
from __future__ import annotations

import torch

from eioku_tpu_torch.ops import _cuda


def pair_diff_plain(chain: torch.Tensor) -> torch.Tensor:
    """[N, D] float32 -> [N-1] mean absolute difference of adjacent rows."""
    d = chain.shape[-1]
    return torch.sum(torch.abs(chain[1:] - chain[:-1]), dim=-1) / float(d)


def pair_diff(chain: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference of adjacent rows of a float32 [N, D] chain.

    CPU tensors take the plain version; CUDA tensors launch the kernel (there
    is no fallback on the card)."""
    if chain.dim() != 2 or chain.shape[0] < 2:
        raise ValueError(f"chain must be [N>=2, D], got {tuple(chain.shape)}")
    if chain.dtype != torch.float32:
        raise TypeError(f"chain must be float32, got {chain.dtype}")
    if chain.device.type == "cpu":
        return pair_diff_plain(chain)
    if chain.device.type != "cuda":
        raise ValueError(f"unsupported device {chain.device}")
    chain = chain.contiguous()
    n, d = chain.shape
    out = torch.empty((n - 1,), dtype=torch.float32, device=chain.device)
    stream = torch.cuda.current_stream(chain.device).cuda_stream
    _cuda.launch("scene_diff", "eioku_scene_diff", chain.data_ptr(),
                 out.data_ptr(), n, d, stream)
    return out


def scene_scores(prev_plane: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Score each frame against its predecessor.

    prev_plane: [D], the last frame of the previous batch (zeros for the first
    batch; the caller masks the first frame's score). planes: [B, D] HSV
    planes. Returns [B] scores in [0, 1]."""
    chain = torch.cat([prev_plane[None, :], planes], dim=0)
    return pair_diff(chain)
