"""Neural-net building blocks of the port (from eioku_tpu/models/layers.py).

YOLOv8: activations are NCHW inside the modules (PyTorch's layout); convolution
padding is the symmetric (k-1)//2 that converted torch checkpoints were
trained with, which `nn.Conv2d(padding=k // 2)` is for odd k. Batch norm is
inference-mode with the ultralytics eps 1e-3 and folds into the conv at load
time (`ConvBN.fold`).

ResNets (ResNet18-Places365, ArcFace iresnet18): bias-free convolutions with
the same torch padding (`conv`), batch norm at the torchvision/insightface eps
1e-5 that stays unfolded (`BatchNorm`: the pre-activation blocks normalise
before a padded conv, where a fold is not exact), the k3 s2 p1 max pool and a
per-channel `PReLU`.

Transformers (Whisper, MiniLM): `layer_norm`, `Linear`, `gelu` (tanh form,
Whisper), `gelu_erf` (exact form, MiniLM) and `mha` round where the JAX
package's `layernorm`, `linear`, `jax.nn.gelu` and `mha` round, so a bf16
model computes what the JAX package's bf16 model computes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
RESNET_BN_EPS = 1e-5


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


def conv(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    """Bias-free conv with torch's symmetric k // 2 padding."""
    return nn.Conv2d(c_in, c_out, k, stride, padding=k // 2, bias=False)


class BatchNorm(nn.BatchNorm2d):
    """Inference batch norm over dim 1 of an input of any rank (so also the
    [B, C] feature norm), computed as the JAX package's `batchnorm` computes
    it: scale and shift in fp32 from the statistics, cast to x's type, then
    x * scale + shift. State-dict keys are nn.BatchNorm2d's."""

    def __init__(self, c: int, eps: float = RESNET_BN_EPS):
        super().__init__(c, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        std = torch.sqrt(self.running_var.float() + self.eps)
        scale = self.weight.float() / std
        shift = self.bias.float() - self.running_mean.float() * self.weight.float() / std
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class PReLU(nn.PReLU):
    """Per-channel PReLU (key `weight`, init 0.25) over dim 1, the slope cast
    to x's type."""

    def __init__(self, c: int):
        super().__init__(num_parameters=c, init=0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).view((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, x * w)


def max_pool(x: torch.Tensor, k: int = 5, stride: int = 1) -> torch.Tensor:
    """Max pool with symmetric (k-1)//2 padding: SPPF's k5 s1 p2, ResNet's
    stem k3 s2 p1."""
    return F.max_pool2d(x, k, stride=stride, padding=(k - 1) // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (ultralytics' Upsample mode)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random init from an explicit generator: Kaiming-normal conv weights
    (std sqrt(2/fan_in)), zero conv biases, Xavier-uniform linear weights
    with zero biases, identity batch norm -- the JAX package's `kaiming` /
    `xavier` / `init_batchnorm` scheme (the numbers differ: the generators
    do)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            w = torch.randn(m.weight.shape, generator=generator,
                            dtype=torch.float32) * math.sqrt(2.0 / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = math.sqrt(6.0 / (m.in_features + m.out_features))
            m.weight.copy_(torch.rand(m.weight.shape, generator=generator,
                                      dtype=torch.float32) * 2 * bound - bound)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # gamma 1, beta 0, mean 0, var 1


def load_by_key_names(model: nn.Module, sd: dict, what: str) -> nn.Module:
    """Load a torch-layout state dict (torch tensors or numpy arrays; keys
    optionally 'module.'-prefixed, as DataParallel checkpoints are) into
    `model` by key names; `num_batches_tracked` is ignored. Raises KeyError
    when the keys do not fit."""
    sd = {k.removeprefix("module."): torch.from_numpy(np.array(v, np.float32))
          for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{what} weights do not fit: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model


def jax_conv_weight(w) -> np.ndarray:
    """A JAX package conv weight (HWIO) -> torch's OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def jax_bn_state(prefix: str, p: dict, out: dict) -> None:
    """A JAX package batch norm {gamma, beta, mean, var} -> nn.BatchNorm2d's
    keys under `prefix` in `out`."""
    for ours, theirs in (("gamma", "weight"), ("beta", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
        out[f"{prefix}.{theirs}"] = np.asarray(p[ours], np.float32)


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


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, 0.5 x (1 + erf(x / sqrt 2)): jax.nn.gelu(approximate=False),
    BERT's and MiniLM's activation."""
    return F.gelu(x)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, H * hd] -> a [B, H, S, hd] view."""
    b, s, d = x.shape
    return x.view(b, s, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, hd] -> [B, S, H * hd]."""
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain multi-head attention over projected [B, S, D] inputs, as the JAX
    package's `mha`: scores accumulated in fp32 and divided by sqrt(hd),
    masked positions (mask broadcastable to [B, H, Sq, Sk], True = keep)
    filled with -1e30, softmax in fp32, P cast to v's type, P V accumulated
    in fp32 (a bf16 GEMM's accumulator) and rounded to v's type. Inputs in
    bf16 are exact in fp32 (and in TF32), so the fp32 products of the scores
    are the JAX package's."""
    qh, kh, vh = (split_heads(t, n_heads) for t in (q, k, v))
    scores = (qh.float() @ kh.float().transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return merge_heads(p @ vh)
