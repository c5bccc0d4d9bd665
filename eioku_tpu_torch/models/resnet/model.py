"""ResNet18 for Places365 scene classification as a PyTorch module (port of
eioku_tpu/models/resnet/model.py).

torchvision's resnet18 with a 365-way fc: 7x7 s2 stem, k3 s2 max pool, four
stages of two basic blocks (stride 2 and a 1x1 downsample at the entry of
stages 2-4), global average pool, fc. The module's attribute names are
torchvision's, so a torchvision or places365 state dict loads by key names
(`load_torchvision_state_dict`; no torchvision import); `from_jax_params`
carries the JAX package's parameter tree over (HWIO convs -> OIHW, the fc's
[in, out] `w` -> [out, in]). Inputs are ImageNet-normalised NCHW (`normalize`,
`preprocess`).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models.layers import (
    BatchNorm,
    Linear,
    conv,
    init_weights,
    jax_bn_state,
    jax_conv_weight,
    load_by_key_names,
    max_pool,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

STAGE_CHANNELS = [64, 128, 256, 512]
INPUT_SIZE = 224
NUM_CLASSES = 365


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv1 = conv(c_in, c_out, 3, stride)
        self.bn1 = BatchNorm(c_out)
        self.conv2 = conv(c_out, c_out, 3)
        self.bn2 = BatchNorm(c_out)
        self.downsample = nn.Sequential(conv(c_in, c_out, 1, stride), BatchNorm(c_out)) \
            if stride != 1 or c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet18(nn.Module):
    def __init__(self, num_classes: int = NUM_CLASSES,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        c_in = 64
        for si, c_out in enumerate(STAGE_CHANNELS):
            stride = 1 if si == 0 else 2
            setattr(self, f"layer{si + 1}", nn.Sequential(
                BasicBlock(c_in, c_out, stride), BasicBlock(c_out, c_out, 1)))
            c_in = c_out
        self.fc = Linear(512, num_classes)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, 224, 224] ImageNet-normalised -> logits [B, classes]."""
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, stride=2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3)))


def normalize(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [B, H, W, 3] in [0, 1] -> ImageNet-normalised fp32 [B, 3, H, W]."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(rgb.device)
    std = torch.from_numpy(IMAGENET_STD).to(rgb.device)
    return ((rgb.float() - mean) / std).permute(0, 3, 1, 2)


def preprocess(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [B, 224, 224, 3] -> ImageNet-normalised fp32 NCHW; the
    caller casts to the model's type."""
    return normalize(frames_u8.float() / 255.0)


# -- weights -----------------------------------------------------------------------


def load_torchvision_state_dict(sd: dict, num_classes: int = NUM_CLASSES) -> ResNet18:
    """A torchvision / places365 resnet18 state dict -> the module, fp32 on
    the CPU."""
    return load_by_key_names(ResNet18(num_classes), sd, "resnet18")


def from_jax_params(tree: dict) -> ResNet18:
    """The JAX package's ResNet18 parameter tree (`init_resnet18_params` or
    `convert_torchvision_state_dict`: HWIO convs, unfolded batch norm, fc
    `w` [in, out]) -> the module."""
    sd: dict = {"conv1.weight": jax_conv_weight(tree["conv1"]["w"]),
                "fc.weight": np.asarray(tree["fc"]["w"], np.float32).T,
                "fc.bias": np.asarray(tree["fc"]["b"], np.float32)}
    jax_bn_state("bn1", tree["bn1"], sd)
    for si, blocks in enumerate(tree["layers"]):
        for bi, blk in enumerate(blocks):
            base = f"layer{si + 1}.{bi}"
            for n in ("1", "2"):
                sd[f"{base}.conv{n}.weight"] = jax_conv_weight(blk[f"conv{n}"]["w"])
                jax_bn_state(f"{base}.bn{n}", blk[f"bn{n}"], sd)
            if "down" in blk:
                sd[f"{base}.downsample.0.weight"] = jax_conv_weight(blk["down"]["w"])
                jax_bn_state(f"{base}.downsample.1", blk["down"]["bn"], sd)
    return load_torchvision_state_dict(sd, num_classes=sd["fc.bias"].shape[0])


def _read_labels(path: str) -> list[str]:
    # "/a/apartment_building/outdoor 8" -> "apartment_building/outdoor"
    # (strip only the alphabetical-bucket prefix; the indoor/outdoor
    # qualifier disambiguates class pairs)
    with open(path) as f:
        return [line.split(" ")[0][3:] if line.startswith("/") and len(line) > 3
                else line.split(" ")[0]
                for line in f.read().strip().splitlines()]


def load_places365(cache_dir: str | None, seed: int = 0
                   ) -> tuple[ResNet18, list[str], bool]:
    """(model, class names, pretrained?). Looks for
    resnet18_places365.pth.tar (or .pth) and categories_places365.txt under
    cache_dir; else random init from a torch.Generator seeded with `seed`
    and labels place_0..place_364. The model is fp32 on the CPU."""
    labels = [f"place_{i}" for i in range(NUM_CLASSES)]
    if cache_dir:
        cat = os.path.join(cache_dir, "categories_places365.txt")
        if os.path.isfile(cat):
            labels = _read_labels(cat)
        for name in ("resnet18_places365.pth.tar", "resnet18_places365.pth"):
            ckpt = os.path.join(cache_dir, name)
            if os.path.isfile(ckpt):
                obj = torch.load(ckpt, map_location="cpu", weights_only=False)
                sd = obj.get("state_dict", obj)
                return load_torchvision_state_dict(sd), labels, True
    return ResNet18(generator=torch.Generator().manual_seed(seed)), labels, False
