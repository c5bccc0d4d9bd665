"""Color-space conversions on tensors (port of eioku_tpu/ops/colorspace.py).

Frames travel to the device as planar I420 (half the bytes of RGB) and are
converted back on the device; scene scoring then works on HSV planes.
`to_i420` stays on the host (cv2).
"""
from __future__ import annotations

import numpy as np
import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV. Input [..., 3] float in [0, 1]; output [..., 3] with h, s,
    v all in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb, dim=-1)
    mn = torch.amin(rgb, dim=-1)
    d = mx - mn
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    # hue sector selection
    h_r = torch.remainder((g - b) / safe_d, 6.0)
    h_g = (b - r) / safe_d + 2.0
    h_b = (r - g) / safe_d + 4.0
    h = torch.where(mx == r, h_r, torch.where(mx == g, h_g, h_b)) / 6.0
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-1)


def to_i420(frames) -> np.ndarray:
    """Host-side RGB -> planar I420, one call per batch (cv2). Every frame
    must have even H and W."""
    import cv2

    return np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in frames])


def i420_to_rgb(planes_u8: torch.Tensor) -> torch.Tensor:
    """Planar YUV 4:2:0 (I420) [B, H*3/2, W] uint8 -> RGB float32 [B, H, W, 3]
    in [0, 1].

    Layout: H rows of Y, then the U plane (H/2 x W/2) packed into H/4 rows,
    then V likewise (what cv2.COLOR_RGB2YUV_I420 emits). BT.601 video-range
    matrix, nearest-neighbour chroma upsampling."""
    b, h32, w = planes_u8.shape
    h = h32 * 2 // 3
    # slice the planes at FLAT element offsets: the U plane occupies h*w/4
    # elements from h*w on, which is h/4 whole rows only when h % 4 == 0
    flat = planes_u8.reshape(b, -1)
    y = flat[:, :h * w].reshape(b, h, w).float()
    u = flat[:, h * w:h * w + h * w // 4].reshape(b, h // 2, w // 2)
    v = flat[:, h * w + h * w // 4:].reshape(b, h // 2, w // 2)

    def up2(p):  # [B, H/2, W/2] -> [B, H, W] nearest
        return p[:, :, None, :, None].expand(b, h // 2, 2, w // 2, 2) \
            .reshape(b, h, w).float()

    uc = up2(u) - 128.0
    vc = up2(v) - 128.0
    ys = 1.164 * (y - 16.0)  # video-range Y (16..235), ITU-R BT.601
    r = ys + 1.596 * vc
    g = ys - 0.391 * uc - 0.813 * vc
    bl = ys + 2.018 * uc
    rgb = torch.stack([r, g, bl], dim=-1)
    return torch.clamp(rgb / 255.0, 0.0, 1.0)


def i420_frames_to_hsv_planes(planes_u8: torch.Tensor) -> torch.Tensor:
    """I420 frames [B, H*3/2, W] uint8 -> flattened HSV planes [B, H*W*3]."""
    hsv = rgb_to_hsv(i420_to_rgb(planes_u8))
    return hsv.reshape(hsv.shape[0], -1)
