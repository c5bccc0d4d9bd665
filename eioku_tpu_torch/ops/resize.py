"""Letterbox, resize and normalise on the device (port of
eioku_tpu/ops/resize.py).

Bilinear resize is two dense interpolation products, rows then columns:
out = Ry @ img @ Rx^T, with the same [n_out, n_in] matrices as the JAX
package's (align_corners=False, cv2.INTER_LINEAR's and jax.image's 'linear'
sampling), built in numpy and cached per geometry. This is not
`F.interpolate`, which samples otherwise. The JAX function is plain
`jnp.einsum` outside any Pallas kernel, so `torch.einsum` is its port. The
products are fp32; on the card they must run with TF32 off (PyTorch's
default for matrix products), or they keep only ~10 bits.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix (align_corners=False,
    matching cv2.INTER_LINEAR / jax.image 'linear')."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        w_hi = src - lo
        lo_c = min(max(lo, 0), n_in - 1)
        hi_c = min(max(lo + 1, 0), n_in - 1)
        m[o, lo_c] += 1.0 - w_hi
        m[o, hi_c] += w_hi
    return m


def resize_bilinear(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """frames [B, H, W, C] (any float or integer type) -> [B, out_h, out_w, C]
    fp32 on the frames' device: rows ([oh, H] over H), then columns."""
    _, h, w, _ = frames.shape
    x = frames.float()
    ry = torch.from_numpy(_interp_matrix(h, out_h)).to(x.device)
    rx = torch.from_numpy(_interp_matrix(w, out_w)).to(x.device)
    x = torch.einsum("oh,bhwc->bowc", ry, x)
    return torch.einsum("pw,bowc->bopc", rx, x)


def letterbox_resize_normalize(frames_u8: torch.Tensor, out_h: int, out_w: int,
                               pad_value: float = 114.0) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> fp32 [B, out_h, out_w, 3] in [0, 1], aspect
    preserved, gray padding; the scale and pad arithmetic of
    ml/detection.py's `letterbox_batch`."""
    b, h, w, _ = frames_u8.shape
    scale = min(out_h / h, out_w / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_y, pad_x = (out_h - nh) // 2, (out_w - nw) // 2
    out = torch.full((b, out_h, out_w, 3), pad_value, dtype=torch.float32,
                     device=frames_u8.device)
    out[:, pad_y:pad_y + nh, pad_x:pad_x + nw] = resize_bilinear(frames_u8, nh, nw)
    return out / 255.0


def letterbox_geometry(h: int, w: int, size: int) -> tuple[float, int, int]:
    """(scale, pad_x, pad_y) used to map boxes back to source pixels."""
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return scale, (size - nw) // 2, (size - nh) // 2
