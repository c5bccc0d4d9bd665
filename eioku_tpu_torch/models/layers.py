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

CRAFT and CRNN (OCR): `BatchNorm` at eps 1e-5, `max_pool` (also with
"VALID" (h, w) windows) and `upsample2x_bilinear`.

Transformers (Whisper, MiniLM, CLIP): `layer_norm`, `Linear`, `gelu` (tanh
form, Whisper), `gelu_erf` (exact form, MiniLM), `quick_gelu` (CLIP) and
`mha` round where the JAX package's `layernorm`, `linear`, `jax.nn.gelu` and
`mha` round, so a bf16 model computes what the JAX package's bf16 model
computes. `quantize_linears` swaps every linear of a module for a
`QuantLinear` (int8 weights, ops/quant.py), as the JAX package's
`quantize_linears` rewrites every linear of a parameter tree;
`quantize_convs` swaps every folded convolution for a `QuantConv2d`, as the
JAX package's `quantize_convs` rewrites every folded conv of a tree.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.ops.quant import (
    conv2d_q,
    conv2d_q_sliced,
    linear_q,
    quantize_conv,
    quantize_weight,
)

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


def max_pool(x: torch.Tensor, k: int | tuple[int, int] = 5,
             stride: int | tuple[int, int] = 1, padding: str = "TORCH") -> torch.Tensor:
    """Max pool. "TORCH" pads a square window k symmetrically by (k-1)//2:
    SPPF's k5 s1 p2, ResNet's stem k3 s2 p1, CRAFT's k2 s2 p0 and k3 s1 p1.
    "VALID" pads nothing, and then k and stride may be (h, w) pairs: CRNN's
    (2, 1) pools."""
    pad = 0 if padding == "VALID" else (k - 1) // 2
    return F.max_pool2d(x, k, stride=stride, padding=pad)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (ultralytics' Upsample mode)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of NCHW with half-pixel centres (CRAFT's mode).
    At the edges the source coordinate clamps to the border pixel, which is
    what jax.image.resize(method="bilinear") gives there: it drops the
    out-of-range tap and renormalises. No antialias: it upsamples."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


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


def xavier_(t: torch.Tensor, jax_shape: tuple[int, ...], generator: torch.Generator,
            gain: float = 1.0) -> None:
    """The JAX package's `xavier` on its [in, out] layout: uniform in
    +-sqrt(6 / (shape[0] + shape[-1])), times `gain`."""
    bound = math.sqrt(6.0 / (jax_shape[0] + jax_shape[-1]))
    t.uniform_(-bound, bound, generator=generator).mul_(gain)


def load_state(model: nn.Module, sd: dict[str, np.ndarray]) -> nn.Module:
    """Copy a full state dict into `model` (its device and types), checking
    every shape; keys the model does not have are ignored."""
    params = model.state_dict()
    missing = sorted(set(params) - set(sd))
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} parameters, e.g. {missing[:3]}")
    with torch.no_grad():
        for name, p in params.items():
            v = torch.from_numpy(np.array(sd[name], np.float32))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch at {name}: checkpoint "
                                 f"{tuple(v.shape)} vs model {tuple(p.shape)}")
            p.copy_(v.to(p.device, p.dtype))
    return model


def jax_linear_state(prefix: str, p: dict, out: dict) -> None:
    """A JAX package linear {w [in, out], b} -> nn.Linear's keys under
    `prefix` in `out`."""
    out[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T
    out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def jax_ln_state(prefix: str, p: dict, out: dict) -> None:
    """A JAX package layer norm {gamma, beta} -> nn.LayerNorm's keys under
    `prefix` in `out`."""
    out[f"{prefix}.weight"] = np.asarray(p["gamma"], np.float32)
    out[f"{prefix}.bias"] = np.asarray(p["beta"], np.float32)


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


class QuantLinear(nn.Module):
    """An int8 linear (buffers `w_q` int8 [out, in], `w_s` fp32 [out] and the
    float `bias`), computed by ops/quant.py's `linear_q`: the JAX package's
    `linear` on a quantized parameter dict."""

    def __init__(self, w_q: torch.Tensor, w_s: torch.Tensor,
                 bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_s", w_s)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> QuantLinear:
        w_q, w_s = quantize_weight(lin.weight)
        dev = lin.weight.device
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(torch.from_numpy(w_q).to(dev), torch.from_numpy(w_s).to(dev), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_q(x, self.w_q, self.w_s, self.bias)


@torch.no_grad()
def quantize_linears(module: nn.Module) -> nn.Module:
    """Replace every nn.Linear under `module` (in place) by its QuantLinear.
    Embeddings, layer norms and convolutions stay as they are. Returns
    `module`."""
    for name, child in module.named_children():
        if isinstance(child, nn.Linear):
            setattr(module, name, QuantLinear.from_linear(child))
        else:
            quantize_linears(child)
    return module


class QuantConv2d(nn.Module):
    """An int8 convolution (buffers `w_q` int8 [out, in, kh, kw], `w_s` fp32
    [out] and the float `bias`, which takes the module's compute type),
    computed by ops/quant.py's `conv2d_q`: the JAX package's quantized conv
    dict. Square kernels, symmetric padding."""

    def __init__(self, w_q: torch.Tensor, w_s: torch.Tensor,
                 bias: torch.Tensor | None, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_s", w_s)
        self.register_buffer("bias", bias)
        self.stride = stride
        self.dilation = dilation

    @classmethod
    def from_conv(cls, conv: nn.Conv2d) -> QuantConv2d:
        w_q, w_s = quantize_conv(conv.weight)
        dev = conv.weight.device
        bias = None if conv.bias is None else conv.bias.detach().clone()
        return cls(torch.from_numpy(w_q).to(dev), torch.from_numpy(w_s).to(dev), bias,
                   conv.stride[0], conv.dilation[0])

    def _apply(self, fn, recurse=True):
        # the scales stay fp32 (the JAX package's) when the module moves to
        # a compute type; they follow it to its device
        w_s = self.w_s
        super()._apply(fn, recurse)
        self.w_s = w_s.to(self.w_q.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_q(x, self.w_q, self.w_s, self.bias, self.stride, self.dilation)

    def forward_parts(self, x: torch.Tensor, parts: tuple[int, ...]) -> torch.Tensor:
        """A 1x1 conv over a channel concatenation of `parts` (channel
        counts), each part quantized with its own scales: the sum of the
        sliced partials (in order), then the bias, as the JAX package's
        neck computes a quantized C2f's cv1."""
        acc, off = None, 0
        for c in parts:
            part = conv2d_q_sliced(x[:, off:off + c], self.w_q, self.w_s, off, off + c)
            acc = part if acc is None else acc + part
            off += c
        return acc if self.bias is None else acc + self.bias.to(acc.dtype)[None, :, None, None]


@torch.no_grad()
def quantize_convs(module: nn.Module) -> nn.Module:
    """Replace every nn.Conv2d under `module` (in place; fold batch norms
    first) by its QuantConv2d. Returns `module`."""
    for name, child in module.named_children():
        if isinstance(child, nn.Conv2d):
            setattr(module, name, QuantConv2d.from_conv(child))
        else:
            quantize_convs(child)
    return module


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
