"""Decoder attention for one query position (the Whisper decoder's step).

On a CUDA tensor `decode_attention` launches the hand-written kernel
csrc/decode_attention.cu, which reads the K/V caches in place (no scaled,
fp32 or transposed copy), shares each K/V row's bytes among the query rows
that read it (a window's beams), and reads a self-attention cache only up to
the device position `pos`. On a CPU tensor it runs `decode_attention_plain`:
the same operations as the Whisper decoder's plain attention (models/whisper/
model.py `_attend`), with G query rows grouped onto one K/V row by an
einsum, and the positions past `pos` masked at -1e30, so they take weight
exactly 0.

Numerics (both versions, summation order aside): q and k each scaled by
hd^-0.25 and rounded to the activation type; scores summed in fp32; the
softmax in fp32 over the whole live row, normalised, then rounded to the
activation type; P V accumulated in fp32 and rounded to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from eioku_tpu_torch.models.layers import merge_heads, split_heads
from eioku_tpu_torch.ops import _cuda

HEAD_DIM = 64  # every Whisper variant's
MAX_GROUP = 8  # query rows per K/V row in one launch; larger groups launch in slices
MAX_SPLITS = 8  # blocks of a cluster per (K/V row, head)
BLOCKS_PER_SM = 3  # blocks a launch aims for, per SM of the card
_MASKED = -1e30  # the plain version's score past the live position (the JAX package's)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def launches() -> int:
    """Launches of the kernel since the last `_cuda.reset_launch_counts()`."""
    return _cuda.launch_counts()["decode_attention"]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
                           pos: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: the decoder's `_attend` where each query row has a
    K/V row of its own; where G consecutive query rows share one, the same
    operations with the G rows as an axis of their own; positions past `pos`
    masked at -1e30."""
    b = k.shape[0]
    g = q.shape[0] // b
    hd = q.shape[-1] // n_heads
    scale = hd ** -0.25
    qh = split_heads(q, n_heads) * scale
    kh = split_heads(k, n_heads) * scale
    vh = split_heads(v, n_heads)
    live = None
    if pos is not None:
        live = (torch.arange(k.shape[1], device=pos.device) <= pos)[None, None, None]
    if g == 1:
        scores = qh.float() @ kh.float().transpose(-1, -2)
        if live is not None:
            scores = scores.masked_fill(~live, _MASKED)
        w = torch.softmax(scores, dim=-1).to(vh.dtype)
        return merge_heads(w @ vh)
    qh = qh.reshape(b, g, n_heads, q.shape[1], hd)
    scores = torch.einsum("bghqd,bhkd->bghqk", qh.float(), kh.float())
    if live is not None:
        scores = scores.masked_fill(~live[None], _MASKED)
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    out = torch.einsum("bghqk,bhkd->bghqd", w, vh)
    return merge_heads(out.reshape(q.shape[0], n_heads, q.shape[1], hd))


@functools.lru_cache(maxsize=None)
def _blocks(device: torch.device) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _check_kernel_input(name: str, t: torch.Tensor) -> None:
    elem = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s * elem % 16 for s in t.stride()[:-1]):
        raise ValueError(f"decode attention kernel: {name} needs a dense last dim, a 16-byte "
                         f"aligned base and strides of whole 16 bytes, got strides "
                         f"{tuple(t.stride())}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
                     pos: torch.Tensor | None = None) -> torch.Tensor:
    """q [B*G, 1, d] (G consecutive rows per K/V row), k and v [B, n, d] ->
    [B*G, 1, d] in q's type. pos: None (all n positions live) or a
    one-element int64 tensor on q's device, the last live position.

    CPU tensors take the plain version. CUDA tensors (bf16, f16 or fp32,
    head dim 64, a dense last dim and 16-byte strides) launch the kernel,
    which reads `pos` on the device (so a CUDA graph captures one launch for
    every position); anything the kernel cannot take raises: there is no
    fallback on the card."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or q.shape[1] != 1:
        raise ValueError(f"q must be [rows, 1, d] and k, v [B, n, d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, frames, d = k.shape
    if v.shape != k.shape or q.shape[2] != d or b == 0 or q.shape[0] % b or frames == 0:
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d % n_heads:
        raise ValueError(f"width {d} does not split into {n_heads} heads")
    if pos is not None and pos.numel() != 1:
        raise ValueError(f"pos must hold one position, got {tuple(pos.shape)}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, n_heads, pos)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device or (
            pos is not None and pos.device != q.device):
        raise ValueError("q, k, v and pos must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes bf16, f16 or fp32 q, k, v of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d // n_heads != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {d // n_heads}")
    if pos is not None and pos.dtype != torch.long:
        raise TypeError(f"pos must be int64, got {pos.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, t)
    group = q.shape[0] // b
    out = torch.empty((q.shape[0], 1, d), dtype=q.dtype, device=q.device)
    # the smallest cluster that fills the card: 3 blocks a row and head for
    # the batched decode's cross-attention, 1 for its self-attention
    splits = max(1, min(MAX_SPLITS, frames, -(-_blocks(q.device) // (b * n_heads))))
    strides = (ctypes.c_longlong * 6)(q.stride(0), out.stride(0), k.stride(0), k.stride(1),
                                      v.stride(0), v.stride(1))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pos_ptr = pos.data_ptr() if pos is not None else None
    for g0 in range(0, group, MAX_GROUP):  # rows g0.. of every group
        _cuda.launch("decode_attention", "eioku_decode_attention", q[g0].data_ptr(),
                     k.data_ptr(), v.data_ptr(), out[g0].data_ptr(), pos_ptr, b, n_heads,
                     frames, group, min(MAX_GROUP, group - g0), d // n_heads, strides,
                     float((d // n_heads) ** -0.25), splits, _DTYPE_CODES[q.dtype], stream)
    return out
