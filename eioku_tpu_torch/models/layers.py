"""Neural-net building blocks of the port (from eioku_tpu/models/layers.py).

YOLOv8: activations are NCHW inside the modules (PyTorch's layout); convolution
padding is the symmetric (k-1)//2 that converted torch checkpoints were
trained with, which `nn.Conv2d(padding=k // 2)` is for odd k. Batch norm is
inference-mode with the ultralytics eps 1e-3 and folds into the conv at load
time (`ConvBN.fold`).

Transformers (Whisper): `layer_norm`, `Linear` and `gelu` round where the
JAX package's `layernorm`, `linear` and `jax.nn.gelu` round, so a bf16 model
computes what the JAX package's bf16 model computes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm -> SiLU; after `fold()`, conv+bias -> SiLU.

    Attribute names (`conv`, `bn`) follow the ultralytics `Conv` block so that
    its state-dict keys map one to one."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))

    @torch.no_grad()
    def fold(self) -> None:
        """Fold the inference BN affine y = x*s + t (s = gamma/sqrt(var+eps),
        t = beta - mean*s) into the conv: w' = w*s per output channel, b' = t.
        Computed in fp32 with the same operations as the JAX package's
        `fold_batchnorm`."""
        if not isinstance(self.bn, nn.BatchNorm2d):
            return
        bn, conv = self.bn, self.conv
        s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        folded = nn.Conv2d(conv.in_channels, conv.out_channels,
                           conv.kernel_size, conv.stride, conv.padding,
                           bias=True, device=conv.weight.device,
                           dtype=conv.weight.dtype)
        folded.weight.copy_(conv.weight * s[:, None, None, None])
        folded.bias.copy_(bn.bias - bn.running_mean * s)
        self.conv = folded
        self.bn = nn.Identity()


def max_pool(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Stride-1 max pool with symmetric (k-1)//2 padding (SPPF's k5 s1 p2)."""
    return F.max_pool2d(x, k, stride=1, padding=(k - 1) // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (ultralytics' Upsample mode)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random init from an explicit generator: Kaiming-normal conv weights
    (std sqrt(2/fan_in)), zero conv biases, identity batch norm -- the JAX
    package's `kaiming` / `init_batchnorm` scheme (the numbers differ: the
    generators do)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            w = torch.randn(m.weight.shape, generator=generator,
                            dtype=torch.float32) * math.sqrt(2.0 / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # gamma 1, beta 0, mean 0, var 1


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Statistics in fp32 (population variance), the normalised value cast to
    x's type, then gamma and beta applied in x's type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm's parameters (`weight`, `bias`) with `layer_norm`'s
    rounding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Linear):
    """x W^T with fp32 accumulation, rounded to x's type, then + b in x's
    type (the bias is added after the rounding, as the JAX package adds it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, self.weight.to(x.dtype))
        return out if self.bias is None else out + self.bias.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation: jax.nn.gelu's default
    (torch.nn.functional.gelu defaults to the erf form)."""
    return F.gelu(x, approximate="tanh")
