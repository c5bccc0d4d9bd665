"""Post-training int8 quantization of linear and convolution layers (port of
eioku_tpu/ops/quant.py).

Scheme, as in the JAX package: symmetric per-output-channel int8 weights
(scale max|w| / 127 per output, clamped at 1e-12), quantized once on the host
in numpy from the fp32 view of the stored weights, so `w_q` and `w_s` are
bit-equal to the JAX package's; symmetric per-row dynamic activation
quantization in fp32 at compute time (`torch.round` rounds half to even, as
`jnp.rint` does); an int8 x int8 -> int32 product; dequantization by the
row scale, then the output-channel scale; the result cast to x's type and
the bias added after that cast.

The product is `torch._int_mm`, an exact int32 accumulation on both devices.
This is no port of a TPU kernel: the JAX package computes it with a plain
`jnp.dot(..., preferred_element_type=jnp.int32)` outside any Pallas kernel.
On CUDA `_int_mm` needs more than 16 rows and K and N multiples of 8, so
`linear_q` pads the quantized rows (zeros, sliced away) to a multiple of 8
of at least MIN_ROWS, and K and N to multiples of 8. A float product is not
an option: with K = 5120 a sum of int8 products reaches 127 * 127 * 5120
> 2^24, past fp32's exact integers.

Convolutions (YOLOv8's `int8` option): `quantize_conv` gives per-output-
channel weights (scale over kh, kw and c_in, TensorRT's PTQ granularity),
again from the fp32 view in numpy, so bit-equal to the JAX package's;
`conv2d_q` quantizes each image's activations with one scale over (C, H, W),
pads symmetrically with int8 zeros (exact: the zero point is 0), multiplies
in int32 and dequantizes by sx * w_s, cast to x's type, then adds the bias;
`conv2d_q_sliced` is the 1x1 partial over an input-channel slice that the
JAX package's YOLOv8 neck sums (no bias). `F.conv2d` takes no int8 tensors
on CUDA and a float product is not exact (127^2 * 9 * 128 > 2^24), so the
product is one `int_mm` per tap (int8 zero padding and a strided slice
of the input, no float view), summed in int32. Images go through a conv in
groups whose int32 sums stay under ACC_GROUP_BYTES, so that the int8
detector's peak memory stays near bf16's. The JAX package computes it with
`lax.conv_general_dilated(..., preferred_element_type=jnp.int32)` outside
any Pallas kernel, so a library product is its port.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MIN_ROWS = 32  # _int_mm on CUDA wants more than 16 rows
ALIGN = 8  # ... and K and N multiples of 8
ACC_GROUP_BYTES = 64 * 2**20  # a quantized conv's int32 sums held at once


def quantize_weight(weight: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A linear weight [out, in] (any float type) -> (w_q int8 [out, in],
    w_s fp32 [out]), with the JAX package's `quantize_linear` arithmetic on
    its [in, out] layout."""
    w = weight.detach().float().cpu().numpy().T  # [in, out], as in JAX
    s = np.max(np.abs(w), axis=0) / 127.0
    s = np.maximum(s, 1e-12)  # all-zero columns: keep the scale finite
    wq = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return np.ascontiguousarray(wq.T), s.astype(np.float32)


def quant_act(x: torch.Tensor, dims=-1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale over `dims` (the last axis:
    per row), in fp32: (x_q int8, s_x fp32 with `dims` kept as 1)."""
    xf = x.float()
    # max |x| from the largest and the negated smallest value: exact, and no
    # fp32 |x| temporary beside xf
    amax = torch.maximum(xf.amax(dim=dims, keepdim=True),
                         -xf.amin(dim=dims, keepdim=True))
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds otherwise than the JAX package's division
    sx = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    # in place on the fp32 copy (not on an fp32 x itself): one fp32 copy of
    # the activations at a time, the same values as out-of-place
    q = xf.div_(sx) if xf is not x else xf / sx
    return q.round_().clamp_(-127, 127).to(torch.int8), sx


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 times w_q [N, K] int8 transposed -> [M, N] int32,
    padding M, K and N with zeros to `_int_mm`'s shapes."""
    m, k = xq.shape
    n = w_q.shape[0]
    mp, kp, np_ = max(_round_up(m, ALIGN), MIN_ROWS), _round_up(k, ALIGN), _round_up(n, ALIGN)
    if (mp, kp) != (m, k):
        xq = F.pad(xq, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w_q = F.pad(w_q, (0, kp - k, 0, np_ - n))
    return torch._int_mm(xq, w_q.t())[:m, :n]


def linear_q(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] through a quantized linear (w_q int8 [N, K], w_s fp32 [N])
    -> [..., N] in x's type."""
    xq, sx = quant_act(x)
    lead = x.shape[:-1]
    acc = int_mm(xq.reshape(-1, x.shape[-1]), w_q).reshape(*lead, -1)
    out = acc.float().mul_(sx).mul_(w_s).to(x.dtype)
    return out if bias is None else out + bias.to(x.dtype)


def quantize_conv(weight: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A folded conv weight [out, in, kh, kw] (any float type) -> (w_q int8
    [out, in, kh, kw], w_s fp32 [out]), with the JAX package's
    `quantize_conv` arithmetic on its HWIO layout."""
    w = np.transpose(weight.detach().float().cpu().numpy(), (2, 3, 1, 0))  # HWIO
    s = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s = np.maximum(s, 1e-12)
    wq = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return np.ascontiguousarray(np.transpose(wq, (3, 2, 0, 1))), s.astype(np.float32)


def _out_hw(h: int, w: int, kh: int, kw: int, stride: int, dilation: int
            ) -> tuple[int, int]:
    """A conv's output size with symmetric padding dilation * (k-1) // 2."""
    return ((h + 2 * (dilation * (kh - 1) // 2) - dilation * (kh - 1) - 1) // stride + 1,
            (w + 2 * (dilation * (kw - 1) // 2) - dilation * (kw - 1) - 1) // stride + 1)


def conv_int32(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
               dilation: int = 1) -> torch.Tensor:
    """The exact int8 convolution: xq [B, C, H, W] int8, w_q [O, C, kh, kw]
    int8 -> [B, O, H', W'] int32, with symmetric padding dilation * (k-1) //
    2 (torch's, the JAX package's "TORCH" convention). One `int_mm` per
    tap, each over that tap's strided slice [B*H'*W', C], summed into one
    int32 accumulator: the same integer sum as one im2col product, with one
    tap's copy of the input held at a time instead of kh*kw."""
    b, c, h, w = xq.shape
    o, _, kh, kw = w_q.shape
    ph, pw = dilation * (kh - 1) // 2, dilation * (kw - 1) // 2
    ho, wo = _out_hw(h, w, kh, kw, stride, dilation)
    xp = F.pad(xq, (pw, pw, ph, ph)).permute(0, 2, 3, 1)  # [B, H, W, C] view
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i * dilation:i * dilation + (ho - 1) * stride + 1:stride,
                     j * dilation:j * dilation + (wo - 1) * stride + 1:stride]
            part = int_mm(tap.reshape(-1, c), w_q[:, :, i, j].contiguous())
            acc = part if acc is None else acc.add_(part)
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def _conv_q(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor, stride: int,
            dilation: int) -> torch.Tensor:
    """The dequantized int8 conv of x, without the bias, over groups of
    images whose int32 sums stay under ACC_GROUP_BYTES. Each image has its
    own scale, so the groups give the batch's values, and the peak holds
    one group's fp32, int8 and int32 copies beside the output, not the
    batch's (at YOLOv8n's stem on 64 frames, the int32 sums alone are 400
    MiB)."""
    b, _, h, w = x.shape
    o, _, kh, kw = w_q.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, dilation)
    per = max(1, ACC_GROUP_BYTES // (ho * wo * o * 4))
    out = None
    for i in range(0, b, per):
        xq, sx = quant_act(x[i:i + per], dims=(1, 2, 3))
        # the int32 sums go as soon as their fp32 copy exists; scaled in place
        y = conv_int32(xq, w_q, stride, dilation).float()
        y = y.mul_(sx).mul_(w_s[None, :, None, None]).to(x.dtype)
        if per >= b:
            return y
        if out is None:
            out = y.new_empty((b, *y.shape[1:]))
        out[i:i + per] = y
    return out


def conv2d_q(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
             bias: torch.Tensor | None = None, stride: int = 1,
             dilation: int = 1) -> torch.Tensor:
    """x [B, C, H, W] through a quantized conv -> [B, O, H', W'] in x's type:
    one activation scale per image, int32 products, dequantized by sx, then
    w_s, cast to x's type, then the bias in x's type."""
    out = _conv_q(x, w_q, w_s, stride, dilation)
    return out if bias is None else out.add_(bias.to(x.dtype)[None, :, None, None])


def conv2d_q_sliced(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                    c_lo: int, c_hi: int) -> torch.Tensor:
    """The 1x1 partial over input channels c_lo:c_hi of a quantized conv, no
    bias: x [B, c_hi - c_lo, H, W] quantized with its own per-image scale.
    Per-output scales survive the slicing, so the dequantized partials sum
    like the float partials."""
    return _conv_q(x, w_q[:, c_lo:c_hi], w_s, 1, 1)
