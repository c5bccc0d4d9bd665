"""The tail of a residual branch and the next LayerNorm, as one op (the
Whisper decoder step's).

`add_layer_norm(x, w, beta, eps, y, b)` adds a linear's product `y` and its
bias `b` into the residual stream `x` in place, then returns `x`'s
LayerNorm: with y omitted, the LayerNorm alone, and x is left as it is.

On a CUDA tensor it launches the hand-written kernel csrc/add_layer_norm.cu
(one block a row, one thread a 16-byte vector of it, the statistics by warp
shuffles and the warps' sums in shared memory). On a CPU tensor it runs
`add_layer_norm_plain`: the operations the decoder ran before the op, the
`Linear` bias add, the residual add and models/layers.py `layer_norm`.

Numerics (both versions, summation order aside): y + b and x + (y + b) each
rounded to x's type; the mean and the population variance in fp32; the
normalised value rounded to x's type, then gamma and beta applied in it,
each rounded.
"""
from __future__ import annotations

import ctypes

import torch

from eioku_tpu_torch.models.layers import layer_norm
from eioku_tpu_torch.ops import _cuda

MAX_WIDTH = 1280  # the largest row the kernel holds in registers (large-v3's)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def launches() -> int:
    """Launches of the kernel since the last `_cuda.reset_launch_counts()`."""
    return _cuda.launch_counts()["add_layer_norm"]


def add_layer_norm_plain(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5, y: torch.Tensor | None = None,
                         b: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: `x += y + b` in place (the bias add, then the
    residual add, each in x's type), then `layer_norm(x, w, beta, eps)`."""
    if y is not None:
        x.add_(y if b is None else y + b.to(y.dtype))
    return layer_norm(x, w, beta, eps)


def _rows(name: str, t: torch.Tensor, d: int) -> torch.Tensor:
    """t as a [rows, d] view whose rows the kernel can read: a dense last dim,
    a 16-byte aligned base and a row stride of whole 16 bytes."""
    try:
        rows = t.view(-1, d)
    except RuntimeError as e:
        raise ValueError(f"add_layer_norm kernel: {name}'s leading dims do not collapse to "
                         f"one row stride, got strides {tuple(t.stride())}") from e
    elem = t.element_size()
    if rows.stride(1) != 1 or t.data_ptr() % 16 or rows.stride(0) * elem % 16:
        raise ValueError(f"add_layer_norm kernel: {name} needs a dense last dim, a 16-byte "
                         f"aligned base and rows of whole 16 bytes, got strides "
                         f"{tuple(t.stride())}")
    return rows


def add_layer_norm(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
                   y: torch.Tensor | None = None,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., d] (updated in place where y is given), y like x or None, w,
    beta and b [d] (b None for no bias; it needs y) -> h like x, in x's type.

    CPU tensors take the plain version. CUDA tensors (bf16, f16 or fp32,
    d a multiple of 8 up to 1280, rows of whole 16 bytes) launch the
    kernel; w, beta and b are taken in x's type, as `layer_norm` and
    `Linear` take them. Anything the kernel cannot take raises: there is no
    fallback on the card."""
    d = x.shape[-1]
    if y is not None and y.shape != x.shape:
        raise ValueError(f"y {tuple(y.shape)} must have x's shape {tuple(x.shape)}")
    if b is not None and y is None:
        raise ValueError("a bias needs the product y it is added to")
    for name, t in (("w", w), ("beta", beta), ("b", b)):
        if t is not None and tuple(t.shape) != (d,):
            raise ValueError(f"{name} must be [{d}], got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, w, beta, eps, y, b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if any(t is not None and t.device != x.device for t in (y, w, beta, b)):
        raise ValueError("x, y, w, beta and b must be on one device")
    if x.dtype not in _DTYPE_CODES or (y is not None and y.dtype != x.dtype):
        raise TypeError(f"the kernel takes bf16, f16 or fp32 x and y of one type, got "
                        f"{x.dtype}, {None if y is None else y.dtype}")
    if d % 8 or not 8 <= d <= MAX_WIDTH:
        raise ValueError(f"the kernel takes widths that are multiples of 8 up to {MAX_WIDTH}, "
                         f"got {d}")
    h = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    xr, hr = _rows("x", x, d), h.view(-1, d)
    yr = None if y is None else _rows("y", y, d)
    br, wr, er = (None if t is None else _rows(name, t.to(x.dtype), d)
                  for name, t in (("b", b), ("w", w), ("beta", beta)))
    strides = (ctypes.c_longlong * 3)(xr.stride(0), 0 if yr is None else yr.stride(0),
                                      hr.stride(0))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _cuda.launch("add_layer_norm", "eioku_add_layer_norm", xr.data_ptr(), ptr(yr), ptr(br),
                 wr.data_ptr(), er.data_ptr(), hr.data_ptr(), xr.shape[0], d, strides,
                 float(eps), _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    return h
