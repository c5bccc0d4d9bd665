"""Post-training int8 quantization of linear layers (port of the linear half
of eioku_tpu/ops/quant.py).

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

Convolutions (`quantize_conv(s)`, `conv2d_q`) belong to the detection options
and are not ported here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MIN_ROWS = 32  # _int_mm on CUDA wants more than 16 rows
ALIGN = 8  # ... and K and N multiples of 8


def quantize_weight(weight: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A linear weight [out, in] (any float type) -> (w_q int8 [out, in],
    w_s fp32 [out]), with the JAX package's `quantize_linear` arithmetic on
    its [in, out] layout."""
    w = weight.detach().float().cpu().numpy().T  # [in, out], as in JAX
    s = np.max(np.abs(w), axis=0) / 127.0
    s = np.maximum(s, 1e-12)  # all-zero columns: keep the scale finite
    wq = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return np.ascontiguousarray(wq.T), s.astype(np.float32)


def quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization over the last axis, in fp32:
    (x_q int8, s_x fp32 [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds otherwise than the JAX package's division
    sx = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    xq = torch.round(xf / sx).clamp_(-127, 127).to(torch.int8)
    return xq, sx


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
    out = (acc.float() * sx * w_s).to(x.dtype)
    return out if bias is None else out + bias.to(x.dtype)
