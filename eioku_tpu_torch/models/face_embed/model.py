"""ArcFace iresnet18 face embedder as a PyTorch module (port of
eioku_tpu/models/face_embed/model.py).

Identity embeddings for cross-video face clustering (the People view).
insightface's iresnet18 ("r18" ArcFace backbone): 3x3 stem (no max pool),
four stages of pre-activation IBasicBlocks [2, 2, 2, 2] with per-channel
PReLU and stride 2 at each stage entry, then BN -> flatten (512*7*7) -> fc
512 -> feature BN. Inputs are 112x112 RGB in [-1, 1] (((x/255)-0.5)/0.5).
Attribute names are insightface arcface_torch's, so its state dicts
(ms1mv3_arcface_r18's backbone.pth) load by key names; `from_jax_params`
carries the JAX package's tree over. Embeddings are L2-normalised by the
caller.

The JAX forward transposes its NHWC activations to C-major before the fc;
an NCHW flatten already is C-major, so the fc weight is just `w.T`. The
head (fc and feature BN) runs in fp32 whatever the trunk's type.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from eioku_tpu_torch.models.layers import (
    BatchNorm,
    PReLU,
    conv,
    init_weights,
    jax_bn_state,
    jax_conv_weight,
    load_by_key_names,
)

INPUT_SIZE = 112
EMBED_DIM = 512
STAGE_CHANNELS = [64, 128, 256, 512]
CHECKPOINT_NAMES = ("arcface_r18.pth", "arcface_r18/backbone.pth", "backbone.pth")


class IBasicBlock(nn.Module):
    """bn1 -> conv1 -> bn2 -> prelu -> conv2 (stride) -> bn3, plus the
    (optionally downsampled) identity."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.bn1 = BatchNorm(c_in)
        self.conv1 = conv(c_in, c_out, 3)
        self.bn2 = BatchNorm(c_out)
        self.prelu = PReLU(c_out)
        self.conv2 = conv(c_out, c_out, 3, stride)
        self.bn3 = BatchNorm(c_out)
        self.downsample = nn.Sequential(conv(c_in, c_out, 1, stride), BatchNorm(c_out)) \
            if stride != 1 or c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn2(self.conv1(self.bn1(x))))
        h = self.bn3(self.conv2(h))
        return h + (x if self.downsample is None else self.downsample(x))


class IResNet18(nn.Module):
    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = conv(3, 64, 3)
        self.bn1 = BatchNorm(64)
        self.prelu = PReLU(64)
        c_in = 64
        for si, c_out in enumerate(STAGE_CHANNELS):
            setattr(self, f"layer{si + 1}", nn.Sequential(
                IBasicBlock(c_in, c_out, 2), IBasicBlock(c_out, c_out, 1)))
            c_in = c_out
        self.bn2 = BatchNorm(512)
        self.fc = nn.Linear(512 * 7 * 7, EMBED_DIM)
        self.features = BatchNorm(EMBED_DIM)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, 112, 112] in [-1, 1] -> [B, 512] (not normalised)."""
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.bn2(x).flatten(1).float()
        x = nn.functional.linear(x, self.fc.weight.float(), self.fc.bias.float())
        return self.features(x)


def preprocess(crops: np.ndarray) -> np.ndarray:
    """uint8 [B, 112, 112, 3] RGB -> float32 in [-1, 1] (insightface norm)."""
    return (crops.astype(np.float32) / 255.0 - 0.5) / 0.5


# -- weights -----------------------------------------------------------------------


def load_arcface_state_dict(sd: dict) -> IResNet18:
    """An insightface arcface_torch iresnet18 state dict -> the module, fp32
    on the CPU."""
    return load_by_key_names(IResNet18(), sd, "iresnet18")


def from_jax_params(tree: dict) -> IResNet18:
    """The JAX package's iresnet18 tree (`init_face_embed_params` or
    `convert_arcface_state_dict`) -> the module."""
    sd: dict = {"conv1.weight": jax_conv_weight(tree["conv1"]["w"]),
                "prelu.weight": np.asarray(tree["prelu"], np.float32),
                "fc.weight": np.asarray(tree["fc"]["w"], np.float32).T,
                "fc.bias": np.asarray(tree["fc"]["b"], np.float32)}
    for name in ("bn1", "bn2", "features"):
        jax_bn_state(name, tree[name], sd)
    for si, stage in enumerate(tree["layers"]):
        for bi, blk in enumerate(stage):
            base = f"layer{si + 1}.{bi}"
            for n in ("1", "2"):
                sd[f"{base}.conv{n}.weight"] = jax_conv_weight(blk[f"conv{n}"]["w"])
            for n in ("1", "2", "3"):
                jax_bn_state(f"{base}.bn{n}", blk[f"bn{n}"], sd)
            sd[f"{base}.prelu.weight"] = np.asarray(blk["prelu"], np.float32)
            if "down" in blk:
                sd[f"{base}.downsample.0.weight"] = jax_conv_weight(blk["down"]["w"])
                jax_bn_state(f"{base}.downsample.1", blk["down"]["bn"], sd)
    return load_arcface_state_dict(sd)


def load_face_embed(cache_dir: str | None, seed: int = 0) -> tuple[IResNet18, bool]:
    """(model, pretrained?): `{cache_dir}/arcface_r18.pth` (or insightface's
    backbone.pth under arcface_r18/, or backbone.pth) when present, else
    random init from a torch.Generator seeded with `seed`. fp32 on the CPU."""
    if cache_dir:
        for name in CHECKPOINT_NAMES:
            path = os.path.join(cache_dir, name)
            if os.path.isfile(path):
                sd = torch.load(path, map_location="cpu", weights_only=True)
                return load_arcface_state_dict(sd), True
    return IResNet18(generator=torch.Generator().manual_seed(seed)), False
