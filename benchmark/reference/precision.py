"""The references' arithmetic: float32 by default (TF32 off, set by the
caller), or float8 (e4m3) for the control, the nearest precision below the
bfloat16 that the configurations state. In float8 every operand of a matrix
product is rounded to e4m3 with one scale per row (absmax / 448) and the
product is accumulated in float32, as a float8 tensor-core product is.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to e4m3 with a scale per slice along `dim`, back in fp32."""
    x = x.float()
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """Matrix products in the reference's precision: `quant` None (float32)
    or "fp8"."""

    def __init__(self, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.quant = quant

    def q(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return round_fp8(x, dim) if self.quant else x.float()

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
        """x [..., in] @ w[out, in]^T (+ b)."""
        out = self.q(x) @ self.q(w).T
        return out if b is None else out + b.float()

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., m, k] @ b [..., k, n], both operands rounded along k."""
        return self.q(a, -1) @ self.q(b, -2)

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
        """x [B, C, T]; w [out, in, k]: rounded per time step and per output
        channel."""
        xq = self.q(x, 1)
        wq = self.q(w.reshape(w.shape[0], -1)).reshape(w.shape) if self.quant else w.float()
        return torch.nn.functional.conv1d(xq, wq, b.float(), stride=stride, padding=padding)
