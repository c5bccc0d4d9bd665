"""CRAFT text detector as a PyTorch module (port of
eioku_tpu/models/ocr/craft.py).

VGG16-BN trunk (through conv5_2, then a 3x3 stride-1 max pool and the
dilated fc6 / fc7 convs), U-Net style double convs over four skips with
bilinear 2x upsampling between them, and a 2-channel head (region score,
affinity score) at half the input resolution. Box extraction from the maps
stays on the host (ml/ocr_task.py).

Attribute names are those of EasyOCR's `craft_mlt_25k.pth`: the trunk in
`basenet.slice1..4` with torchvision's global feature indices
(`basenet.slice1.0` conv, `.1` its batch norm, ...), fc6 / fc7 in
`basenet.slice5.{1,2}`, the double convs in `upconvN.conv.{0,1,3,4}` (conv,
bn, conv, bn) and the head in `conv_cls.{0,2,4,6,8}`, so the public
checkpoint loads by key names. The public checkpoint's quirks are kept, as
the JAX package's `craft_forward` keeps them: each slice ends at a batch
norm, so the U-Net skips are the PRE-ReLU outputs after convs 4, 6, 9 and
12; slice 5 reads the pre-ReLU bn5_2; fc6 and fc7 have no activation; batch
norm eps is 1e-5.

Input NCHW, normalised with ImageNet's mean and std, H and W divisible by
32; output NHWC [B, H/2, W/2, 2], as EasyOCR's CRAFT returns it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models.layers import (
    BatchNorm,
    RESNET_BN_EPS,
    init_weights,
    jax_bn_state,
    jax_conv_weight,
    load_by_key_names,
    max_pool,
    upsample2x_bilinear,
)

# the trunk's 12 convs: (slice, torchvision feature index of the conv, out
# channels); its batch norm sits at index + 1. Pools (k2 s2) follow convs
# 2, 4, 7 and 10; the skips are taken after convs 4, 6, 9 and 12 (each
# slice's last batch norm).
VGG_CONVS = [
    ("slice1", 0, 64), ("slice1", 3, 64), ("slice1", 7, 128), ("slice1", 10, 128),
    ("slice2", 14, 256), ("slice2", 17, 256),
    ("slice3", 20, 256), ("slice3", 24, 512), ("slice3", 27, 512),
    ("slice4", 30, 512), ("slice4", 34, 512), ("slice4", 37, 512),
]
_POOL_AFTER = {2, 4, 7, 10}
# (c_in incl. the skip, c_mid, c_out) of upconv1..4
_UPCONVS = [(1024 + 512, 512, 256), (256 + 512, 256, 128), (128 + 256, 128, 64),
            (64 + 128, 64, 32)]
_HEAD = [(32, 32, 3), (32, 32, 3), (32, 16, 3), (16, 16, 1), (16, 2, 1)]


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=RESNET_BN_EPS)


class DoubleConv(nn.Module):
    """1x1 conv, bn, ReLU, 3x3 conv, bn, ReLU (EasyOCR's `double_conv`)."""

    def __init__(self, c_in: int, c_mid: int, c_out: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("0", nn.Conv2d(c_in, c_mid, 1))
        self.conv.add_module("1", _bn(c_mid))
        self.conv.add_module("3", nn.Conv2d(c_mid, c_out, 3, padding=1))
        self.conv.add_module("4", _bn(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.relu(c[1](c[0](x)))
        return F.relu(c[3](c[2](x)))


class Basenet(nn.Module):
    def __init__(self):
        super().__init__()
        c_in = 3
        for name in ("slice1", "slice2", "slice3", "slice4"):
            setattr(self, name, nn.Sequential())
        for slc, idx, c_out in VGG_CONVS:
            s = getattr(self, slc)
            s.add_module(str(idx), nn.Conv2d(c_in, c_out, 3, padding=1))
            s.add_module(str(idx + 1), _bn(c_out))
            c_in = c_out
        self.slice5 = nn.Sequential()
        self.slice5.add_module("1", nn.Conv2d(512, 1024, 3, padding=6, dilation=6))
        self.slice5.add_module("2", nn.Conv2d(1024, 1024, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """-> [fc7, relu5_3, relu4_3, relu3_2, relu2_2] (the skips pre-ReLU)."""
        skips = []
        for i, (slc, idx, _) in enumerate(VGG_CONVS, start=1):
            s = getattr(self, slc)
            pre = s._modules[str(idx + 1)](s._modules[str(idx)](x))
            if i in (4, 6, 9, 12):
                skips.append(pre)
            # the trunk goes on through a ReLU, except after the last conv:
            # slice 5 reads bn5_2 pre-ReLU
            x = pre if i == len(VGG_CONVS) else F.relu(pre)
            if i in _POOL_AFTER:
                x = max_pool(x, 2, stride=2)
        y = max_pool(x, 3, stride=1)
        y = self.slice5[1](self.slice5[0](y))  # fc6 (dilated), fc7: no activation
        return [y] + skips[::-1]


class CRAFT(nn.Module):
    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.basenet = Basenet()
        for u, (c_in, c_mid, c_out) in enumerate(_UPCONVS, start=1):
            setattr(self, f"upconv{u}", DoubleConv(c_in, c_mid, c_out))
        self.conv_cls = nn.Sequential()
        for i, (c_in, c_out, k) in enumerate(_HEAD):
            self.conv_cls.add_module(str(2 * i), nn.Conv2d(c_in, c_out, k, padding=k // 2))
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] normalised -> score maps [B, H/2, W/2, 2]."""
        fc7, s5, s4, s3, s2 = self.basenet(x)
        y = self.upconv1(torch.cat([fc7, s5], dim=1))
        y = self.upconv2(torch.cat([upsample2x_bilinear(y), s4], dim=1))
        y = self.upconv3(torch.cat([upsample2x_bilinear(y), s3], dim=1))
        h = self.upconv4(torch.cat([upsample2x_bilinear(y), s2], dim=1))
        head = list(self.conv_cls)
        for conv in head[:-1]:
            h = F.relu(conv(h))
        return head[-1](h).permute(0, 2, 3, 1)


def load_craft_state_dict(sd: dict) -> CRAFT:
    """An EasyOCR `craft_mlt_25k.pth` state dict (keys optionally
    'module.'-prefixed) -> the module, fp32 on the CPU."""
    return load_by_key_names(CRAFT(), sd, "CRAFT").eval()


def _conv_state(prefix: str, p: dict, out: dict) -> None:
    out[f"{prefix}.weight"] = jax_conv_weight(p["w"])
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def from_jax_params(tree: dict) -> CRAFT:
    """The JAX package's CRAFT tree (`init_craft_params`,
    `convert_craft_state_dict`: HWIO convs, {gamma, beta, mean, var} batch
    norms) -> the module."""
    sd: dict = {}
    for (slc, idx, _), p in zip(VGG_CONVS, tree["vgg"]):
        _conv_state(f"basenet.{slc}.{idx}", p, sd)
        jax_bn_state(f"basenet.{slc}.{idx + 1}", p["bn"], sd)
    _conv_state("basenet.slice5.1", tree["fc"]["fc6"], sd)
    _conv_state("basenet.slice5.2", tree["fc"]["fc7"], sd)
    for u, p in enumerate(tree["up"], start=1):
        for conv, bn, part in ((0, 1, "conv1"), (3, 4, "conv2")):
            _conv_state(f"upconv{u}.conv.{conv}", p[part], sd)
            jax_bn_state(f"upconv{u}.conv.{bn}", p[part]["bn"], sd)
    for i, p in enumerate(tree["head"]):
        _conv_state(f"conv_cls.{2 * i}", p, sd)
    return load_craft_state_dict(sd)
