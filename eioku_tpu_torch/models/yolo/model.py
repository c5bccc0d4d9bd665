"""YOLOv8 as a PyTorch module (port of eioku_tpu/models/yolo/model.py).

The public YOLOv8 design: CSP backbone with C2f blocks and SPPF, PAN neck,
decoupled anchor-free head with distribution-focal-loss box regression. The
module covers the five published variants; weights load from ultralytics
state dicts or from the JAX package's parameter tree (weights.py), or are
drawn from a seeded `torch.Generator`.

Layout: the module computes in NCHW and returns its head outputs flattened
in the JAX package's anchor order (NHWC row-major per level, levels by
stride), so box and class logits pair with the same anchors in both packages.
The neck concatenates its inputs before each C2f (the JAX package splits
that 1x1 conv over the parts instead; the same function up to summation
order). With int8 convolutions (`quantize_convs` after the batch-norm fold,
the detector's `int8` option) the neck's C2fs quantize each part of cv1's
input with its own scale, as the JAX package's split conv does: nearest
upsampling keeps a part's maximum, so the scales and int8 activations are
the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models.layers import (
    ConvBN,
    QuantConv2d,
    init_weights,
    max_pool,
    upsample2x,
)

# depth_multiple, width_multiple, max_channels per variant (public YOLOv8 scales)
YOLO_VARIANTS = {
    "yolov8n": (0.34, 0.25, 1024),
    "yolov8s": (0.34, 0.50, 1024),
    "yolov8m": (0.67, 0.75, 768),
    "yolov8l": (1.00, 1.00, 512),
    "yolov8x": (1.00, 1.25, 512),
}

_BASE_CH = [64, 128, 256, 512, 1024]  # backbone stage widths before scaling
_BASE_DEPTH = [3, 6, 6, 3]  # C2f repeats before scaling


@dataclass(frozen=True, eq=True)
class YoloConfig:
    variant: str = "yolov8n"
    num_classes: int = 80
    reg_max: int = 16
    strides: tuple[int, ...] = (8, 16, 32)
    depth: float = field(init=False)
    width: float = field(init=False)
    max_ch: int = field(init=False)

    def __post_init__(self):
        d, w, m = YOLO_VARIANTS[self.variant]
        object.__setattr__(self, "depth", d)
        object.__setattr__(self, "width", w)
        object.__setattr__(self, "max_ch", m)

    def ch(self, c: int) -> int:
        return int(min(c, self.max_ch) * self.width + 0.5) // 8 * 8 or 8

    def n(self, d: int) -> int:
        return max(int(round(d * self.depth)), 1)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.cv1 = ConvBN(c, c, 3)
        self.cv2 = ConvBN(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """`parts`: the channel counts of a concatenated input (the neck's), whose
    parts a quantized cv1 quantizes apart."""

    def __init__(self, c_in: int, c_out: int, n: int, shortcut: bool,
                 parts: tuple[int, ...] | None = None):
        super().__init__()
        c = c_out // 2
        self.cv1 = ConvBN(c_in, 2 * c, 1)
        self.m = nn.ModuleList(Bottleneck(c, shortcut) for _ in range(n))
        self.cv2 = ConvBN((2 + n) * c, c_out, 1)
        self.parts = parts

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.cv1.conv
        if self.parts is not None and isinstance(conv, QuantConv2d):
            y = F.silu(conv.forward_parts(x, self.parts))
        else:
            y = self.cv1(x)
        outs = list(y.chunk(2, dim=1))
        for m in self.m:
            outs.append(m(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        c = c_in // 2
        self.cv1 = ConvBN(c_in, c, 1)
        self.cv2 = ConvBN(c * 4, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        p1 = max_pool(y, 5)
        p2 = max_pool(p1, 5)
        p3 = max_pool(p2, 5)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


def _detect_branch(c_in: int, c_mid: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(ConvBN(c_in, c_mid, 3), ConvBN(c_mid, c_mid, 3),
                         nn.Conv2d(c_mid, c_out, 1))


class YOLOv8(nn.Module):
    """Attribute names follow the JAX package's parameter tree (stem, down1,
    c2f_1, ..., head_box[i], head_cls[i])."""

    def __init__(self, cfg: YoloConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        ch = [cfg.ch(c) for c in _BASE_CH]
        n = [cfg.n(d) for d in _BASE_DEPTH]
        self.stem = ConvBN(3, ch[0], 3, 2)
        self.down1 = ConvBN(ch[0], ch[1], 3, 2)
        self.c2f_1 = C2f(ch[1], ch[1], n[0], True)
        self.down2 = ConvBN(ch[1], ch[2], 3, 2)
        self.c2f_2 = C2f(ch[2], ch[2], n[1], True)  # -> P3
        self.down3 = ConvBN(ch[2], ch[3], 3, 2)
        self.c2f_3 = C2f(ch[3], ch[3], n[2], True)  # -> P4
        self.down4 = ConvBN(ch[3], ch[4], 3, 2)
        self.c2f_4 = C2f(ch[4], ch[4], n[0], True)
        self.sppf = SPPF(ch[4], ch[4])  # -> P5
        self.neck_c2f_td1 = C2f(ch[4] + ch[3], ch[3], n[0], False, (ch[4], ch[3]))
        self.neck_c2f_td2 = C2f(ch[3] + ch[2], ch[2], n[0], False, (ch[3], ch[2]))  # -> N3
        self.neck_down1 = ConvBN(ch[2], ch[2], 3, 2)
        self.neck_c2f_bu1 = C2f(ch[2] + ch[3], ch[3], n[0], False, (ch[2], ch[3]))  # -> N4
        self.neck_down2 = ConvBN(ch[3], ch[3], 3, 2)
        self.neck_c2f_bu2 = C2f(ch[3] + ch[4], ch[4], n[0], False, (ch[3], ch[4]))  # -> N5
        c_box = max(16, ch[2] // 4, cfg.reg_max * 4)
        c_cls = max(ch[2], min(cfg.num_classes, 100))
        levels = [ch[2], ch[3], ch[4]]
        self.head_box = nn.ModuleList(
            _detect_branch(c, c_box, 4 * cfg.reg_max) for c in levels)
        self.head_cls = nn.ModuleList(
            _detect_branch(c, c_cls, cfg.num_classes) for c in levels)
        if generator is not None:
            init_weights(self, generator)

    @property
    def dtype(self) -> torch.dtype:
        """The activation type: the float convs' type or, once quantized,
        the type of their biases."""
        conv = self.stem.conv
        return conv.weight.dtype if isinstance(conv, nn.Conv2d) else conv.bias.dtype

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: [B, 3, H, W] float in [0, 1], H and W divisible by 32.

        Returns (box_logits [B, A, 4*reg_max], cls_logits [B, A, num_classes])
        with A = sum over strides of H/s * W/s, in the JAX package's anchor
        order."""
        x = self.down1(self.stem(x))
        x = self.c2f_1(x)
        p3 = self.c2f_2(self.down2(x))
        p4 = self.c2f_3(self.down3(p3))
        x = self.c2f_4(self.down4(p4))
        p5 = self.sppf(x)

        t4 = self.neck_c2f_td1(torch.cat([upsample2x(p5), p4], dim=1))
        n3 = self.neck_c2f_td2(torch.cat([upsample2x(t4), p3], dim=1))
        n4 = self.neck_c2f_bu1(torch.cat([self.neck_down1(n3), t4], dim=1))
        n5 = self.neck_c2f_bu2(torch.cat([self.neck_down2(n4), p5], dim=1))

        box_out, cls_out = [], []
        for i, feat in enumerate([n3, n4, n5]):
            b = feat.shape[0]
            # NCHW -> NHWC before flattening: anchors run row-major over (h, w)
            box = self.head_box[i](feat).permute(0, 2, 3, 1)
            cls = self.head_cls[i](feat).permute(0, 2, 3, 1)
            box_out.append(box.reshape(b, -1, 4 * self.cfg.reg_max))
            cls_out.append(cls.reshape(b, -1, self.cfg.num_classes))
        return torch.cat(box_out, dim=1), torch.cat(cls_out, dim=1)


def anchor_points(h: int, w: int, strides: tuple[int, ...],
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Cell-centre anchor points [A, 2] (x, y) and per-anchor stride [A]."""
    pts, strs = [], []
    for s in strides:
        gh, gw = h // s, w // s
        ys = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) * s
        xs = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) * s
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx, yy], dim=-1).reshape(-1, 2))
        strs.append(torch.full((gh * gw,), float(s), dtype=torch.float32,
                               device=device))
    return torch.cat(pts), torch.cat(strs)


def fold_batchnorm(model: YOLOv8) -> YOLOv8:
    """Fold every inference batch norm into its conv, in place; done once at
    load time, so the forward runs conv+bias+SiLU."""
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.fold()
    return model
