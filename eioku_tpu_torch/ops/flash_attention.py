"""Forward attention with an online softmax (flash attention).

Port of eioku_tpu/ops/flash_attention.py. On a CUDA tensor `flash_attention`
launches the hand-written kernel csrc/flash_attention.cu (it replaces the
Pallas `_flash_kernel`); on a CPU tensor it runs `flash_attention_plain`, the
JAX package's `_reference_attention` in PyTorch. Both mask with MASK_VALUE
(-0.7 * float32 max, not -inf) and return zeros for a query row with no
valid key.

Inputs are [B, H, S, D] views. The kernel reads them through their strides
(D dense), so the Whisper encoder passes its [B, S, H, D] projections
without a transpose, and the output is written into a [B, S, H, D] buffer
returned as a [B, H, S, D] view: merging the heads back costs no copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from eioku_tpu_torch.ops import _cuda

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor | None = None,
                          causal: bool = False,
                          scale: float | None = None) -> torch.Tensor:
    """Naive attention with the kernel's masking, in fp32, cast to q's type."""
    b, _, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    col = torch.arange(skv, device=q.device)
    mask = (col[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]
    if causal:
        row = torch.arange(sq, device=q.device)
        mask = mask & (col[None, None, None, :] <= row[None, None, :, None])
    s = torch.where(mask, s, torch.tensor(MASK_VALUE, dtype=torch.float32,
                                          device=q.device))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows get uniform weights from the softmax; zero them
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it through its strides, else a
    dense copy: D must be dense and, for bf16 and f16, the TMA's tensor maps
    need a 16-byte aligned base and strides of whole 16 bytes, none 0 (an
    expanded view) where the extent is above 1."""
    align = 8 if t.dtype in (torch.bfloat16, torch.float16) else 1
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(s % align == 0 and (s > 0 or n == 1)
                  for s, n in zip(t.stride()[:3], t.shape[:3])))
    return t if ok else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor | None = None, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, H, Sq, D], k and v [B, H, Skv, D] -> [B, H, Sq, D] in q's type.

    lengths: [B] valid KV lengths (None = all); scale defaults to D^-0.5.
    D must be 32 or 64 (ValueError otherwise). CPU tensors take the plain
    version; CUDA tensors (bf16, f16 or fp32) launch the kernel, and anything the
    kernel cannot take raises: there is no fallback on the card."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {d}")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B] = [{b}], got {tuple(lengths.shape)}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device or (
            lengths is not None and lengths.device != q.device):
        raise ValueError("q, k, v and lengths must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes bf16, f16 or fp32 q, k, v of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if sq == 0 or skv == 0 or b == 0 or h == 0:
        raise ValueError("empty attention")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    # [B, Sq, H, D] storage, returned as the [B, H, Sq, D] view
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _cuda.launch("flash_attention", "eioku_flash_attention", q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lengths.data_ptr() if lengths is not None else None,
                 b, h, sq, skv, d, strides, float(scale), int(causal),
                 _DTYPE_CODES[q.dtype], stream)
    return out
