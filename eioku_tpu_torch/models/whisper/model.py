"""Whisper encoder-decoder as PyTorch modules (port of
eioku_tpu/models/whisper/model.py).

Public Whisper architecture: mel -> 2x conv1d (GELU, the second with stride
2) -> sinusoidal positions -> pre-LN transformer encoder; decoder with learned
positions, causal self-attention, cross-attention and the output projection
tied to the token embedding. Variants tiny..large-v3 plus large-v3-turbo.

Modules are named after OpenAI's checkpoint keys (`encoder.blocks.N.attn.
query`, `decoder.token_embedding`, ...), so an OpenAI state dict loads one to
one (weights.py). Layouts at the public functions are the JAX package's: mel
[B, n_mels, 3000], encoder states [B, 1500, d], KV caches [L, B, S, d].

The encoder's self-attention goes through ops/flash_attention.py (the
hand-written kernel K3 on the card, its plain version on the CPU). The
decoder step's one-position self- and cross-attention go through
ops/decode_attention.py (a hand-written kernel on the card that reads the
caches in place and the self cache only up to the live position; on the CPU
its plain version, `_attend`'s operations with a window's beams grouped
onto its K/V); each residual branch's tail there (the output linear's bias
add and the residual add) and the LayerNorm after it go through
ops/add_layer_norm.py (a hand-written kernel on the card, the same
operations in plain torch on the CPU). The decoder's other attention is
plain torch, as the JAX package leaves it outside any kernel: the
full-sequence and tensor-parallel decoders (the latter's cross-attention
through the plain version), and `cross_attention_alignment`, whose
cross-attention weights are its output (word timestamps). `decoder_step`
writes the new key/value into the caches IN PLACE (the JAX version returns
updated copies). Any linear may be a `QuantLinear` (int8,
`layers.quantize_linears`). On the card, where the decoder's linears are
float ones, a decode's steps replay one CUDA graph of the step over its
`DecodeBuffers` (`step_graph`, held by models/step_graphs.py, the holder
Moonlight's decode shares).
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models import step_graphs
from eioku_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    QuantLinear,
    gelu,
    merge_heads,
    split_heads,
)
from eioku_tpu_torch.ops import add_layer_norm as add_ln
from eioku_tpu_torch.ops import decode_attention as decode_attn
from eioku_tpu_torch.ops.flash_attention import flash_attention
from eioku_tpu_torch.parallel.collectives import on
from eioku_tpu_torch.parallel.mesh import Mesh, shard_slice
from eioku_tpu_torch.parallel.pipeline import pipeline_transformer_layers
from eioku_tpu_torch.utils.metrics import METRICS

# n_mels, d_model, n_heads, n_enc_layers, n_dec_layers, vocab
WHISPER_VARIANTS = {
    "tiny": (80, 384, 6, 4, 4, 51865),
    "base": (80, 512, 8, 6, 6, 51865),
    "small": (80, 768, 12, 12, 12, 51865),
    "medium": (80, 1024, 16, 24, 24, 51865),
    "large-v3": (128, 1280, 20, 32, 32, 51866),
    "large-v3-turbo": (128, 1280, 20, 32, 4, 51866),
}

N_AUDIO_CTX = 1500  # 30 s at 100 mel frames/s, conv stride 2
N_TEXT_CTX = 448
LN_EPS = 1e-5
_NEG_ATTN = -1e30  # masked decoder attention score (the JAX package's value)


@dataclass(frozen=True)
class WhisperConfig:
    variant: str = "tiny"
    # activation type inside the encoder and decoder: "bfloat16" is the
    # production transcription setting, float32 the parity tests'
    compute_dtype: str = "float32"

    @property
    def n_mels(self):
        return WHISPER_VARIANTS[self.variant][0]

    @property
    def dim(self):
        return WHISPER_VARIANTS[self.variant][1]

    @property
    def n_heads(self):
        return WHISPER_VARIANTS[self.variant][2]

    @property
    def n_enc_layers(self):
        return WHISPER_VARIANTS[self.variant][3]

    @property
    def n_dec_layers(self):
        return WHISPER_VARIANTS[self.variant][4]

    @property
    def vocab_size(self):
        return WHISPER_VARIANTS[self.variant][5]

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[self.compute_dtype]


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position embedding."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32)


# -- modules -------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = Linear(d, d)
        self.key = Linear(d, d, bias=False)  # whisper: no key bias
        self.value = Linear(d, d)
        self.out = Linear(d, d)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, cross: bool):
        super().__init__()
        self.attn = MultiHeadAttention(d)
        self.attn_ln = LayerNorm(d, eps=LN_EPS)
        if cross:
            self.cross_attn = MultiHeadAttention(d)
            self.cross_attn_ln = LayerNorm(d, eps=LN_EPS)
        self.mlp = nn.Sequential(Linear(d, 4 * d), nn.GELU(approximate="tanh"),
                                 Linear(4 * d, d))
        self.mlp_ln = LayerNorm(d, eps=LN_EPS)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.dim
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, cross=False)
                                    for _ in range(cfg.n_enc_layers))
        self.ln_post = LayerNorm(d, eps=LN_EPS)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.dim
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.positional_embedding = nn.Parameter(torch.empty(N_TEXT_CTX, d))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, cross=True)
                                    for _ in range(cfg.n_dec_layers))
        self.ln = LayerNorm(d, eps=LN_EPS)


class Whisper(nn.Module):
    """The parameter tree; the computation lives in the functions below."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = TextDecoder(cfg)


def _xavier_bound(shape: tuple[int, ...]) -> float:
    """The JAX package's `xavier` on its own layouts: fan_in is shape[0] for
    every rank below 4 (so a conv1d WIO [3, in, out] has fan_in 3)."""
    return math.sqrt(6.0 / (shape[0] + shape[-1]))


@torch.no_grad()
def init_whisper(cfg: WhisperConfig, generator: torch.Generator,
                 device: torch.device | str = "cpu") -> Whisper:
    """Random weights from an explicit generator, in fp32, with the JAX
    package's scheme (`init_whisper_params`): xavier-uniform linears and
    convs, zero biases, identity layer norms, embeddings xavier x 0.02. The
    numbers differ from the JAX package's (the generators do); tests carry
    the JAX tree across with weights.from_jax_params instead."""
    with torch.device(device):
        model = Whisper(cfg)

    def uniform(t: torch.Tensor, jax_shape: tuple[int, ...], gain: float = 1.0):
        bound = _xavier_bound(jax_shape)
        t.uniform_(-bound, bound, generator=generator).mul_(gain)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            uniform(m.weight, (m.in_features, m.out_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            uniform(m.weight, (m.kernel_size[0], m.in_channels, m.out_channels))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    dec = model.decoder
    uniform(dec.token_embedding.weight, (cfg.vocab_size, cfg.dim), 0.02)
    uniform(dec.positional_embedding, (N_TEXT_CTX, cfg.dim), 0.02)
    return model


# -- attention ------------------------------------------------------------------------


def _attend(q, k, v, n_heads: int, mask=None) -> torch.Tensor:
    """Decoder attention: q and k each scaled by hd^-0.25 in the activation
    type, scores and softmax in fp32, P cast to v's type, P V accumulated in
    fp32 and rounded to v's type."""
    scale = (q.shape[-1] // n_heads) ** -0.25
    qh = split_heads(q, n_heads) * scale
    kh = split_heads(k, n_heads) * scale
    vh = split_heads(v, n_heads)
    scores = qh.float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_ATTN)
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    return merge_heads(w @ vh)


def _self_attn(x, attn: MultiHeadAttention, n_heads: int, mask=None):
    q, k, v = attn.query(x), attn.key(x), attn.value(x)
    return attn.out(_attend(q, k, v, n_heads, mask))


def _self_attn_flash(x, attn: MultiHeadAttention, n_heads: int):
    """Encoder self-attention through K3. The projections are handed over
    as [B, S, H, D] views and the output comes back in that layout, so no
    head transpose is copied on the card."""
    q, k, v = attn.query(x), attn.key(x), attn.value(x)
    b, s, d = q.shape
    o = flash_attention(split_heads(q, n_heads), split_heads(k, n_heads),
                        split_heads(v, n_heads))
    return attn.out(o.transpose(1, 2).reshape(b, s, d))


def _mlp(x, block: ResidualAttentionBlock) -> torch.Tensor:
    return block.mlp[2](gelu(block.mlp[0](x)))


# -- encoder -------------------------------------------------------------------------


def _conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """fp32 accumulation rounded to x's type, then + bias in x's type."""
    out = torch.nn.functional.conv1d(x, conv.weight.to(x.dtype), None,
                                     conv.stride, conv.padding)
    return out + conv.bias.to(x.dtype)[:, None]


def _encoder_stem(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """The two convs and the sinusoidal positions: mel [B, n_mels, T] ->
    [B, T/2, d] in the compute type."""
    enc = model.encoder
    x = mel.to(model.cfg.dtype)
    x = gelu(_conv1d(x, enc.conv1))
    x = gelu(_conv1d(x, enc.conv2)).transpose(1, 2)  # [B, S, d]
    pos = torch.from_numpy(sinusoids(x.shape[1], x.shape[2])).to(x.device, x.dtype)
    return x + pos[None]


def _enc_layer(block: ResidualAttentionBlock, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """One encoder block: pre-LN self-attention (K3) and MLP residuals."""
    x = x + _self_attn_flash(block.attn_ln(x), block.attn, n_heads)
    return x + _mlp(block.mlp_ln(x), block)


@torch.no_grad()
def whisper_encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> encoder states [B, 1500, d] in the compute
    type."""
    x = _encoder_stem(model, mel)
    for block in model.encoder.blocks:
        x = _enc_layer(block, x, model.cfg.n_heads)
    return model.encoder.ln_post(x)


# -- decoder --------------------------------------------------------------------------


def _logits(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection, accumulated and returned in fp32."""
    return x.float() @ model.decoder.token_embedding.weight.float().T


def _embed_tokens(model: Whisper, tokens: torch.Tensor) -> torch.Tensor:
    dec = model.decoder
    return (dec.token_embedding.weight[tokens]
            + dec.positional_embedding[:tokens.shape[1]][None]).to(model.cfg.dtype)


def _causal(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()[None, None]


@torch.no_grad()
def whisper_decode_full(model: Whisper, tokens: torch.Tensor,
                        enc_out: torch.Tensor, cross_kv=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] fp32 (full recompute, causal).
    cross_kv: `precompute_cross_kv(model, enc_out)`, to reuse across calls
    on one encoder output (the projections are then not recomputed)."""
    cfg, dec = model.cfg, model.decoder
    x = _embed_tokens(model, tokens)
    causal = _causal(tokens.shape[1], x.device)
    for li, block in enumerate(dec.blocks):
        x = x + _self_attn(block.attn_ln(x), block.attn, cfg.n_heads, mask=causal)
        h = block.cross_attn_ln(x)
        ca = block.cross_attn
        if cross_kv is None:
            k, v = ca.key(enc_out), ca.value(enc_out)
        else:
            k, v = cross_kv[0][li], cross_kv[1][li]
        x = x + ca.out(_attend(ca.query(h), k, v, cfg.n_heads))
        x = x + _mlp(block.mlp_ln(x), block)
    return _logits(model, dec.ln(x))


@torch.no_grad()
def cross_attention_alignment(model: Whisper, tokens: torch.Tensor,
                              enc_out: torch.Tensor,
                              frame_counts: torch.Tensor | None = None,
                              layers_from: int | None = None) -> torch.Tensor:
    """Teacher-forced decoder pass returning text->audio alignment energy
    (the JAX package's `cross_attention_alignment`).

    Collects the cross-attention softmax of the decoder layers from
    `layers_from` (default: the upper half) on, z-normalised per head over
    each window's valid frames (`frame_counts` [B]; the others are masked
    with -1e30 and left out of the statistics) and averaged over the heads.
    The decoder's own attention still sees every frame, as it did while
    decoding. Plain attention: its weights are the output.

    tokens [B, S]; enc_out [B, 1500, d] -> [B, S, 1500] fp32."""
    cfg, dec = model.cfg, model.decoder
    b, s = tokens.shape
    n_frames = enc_out.shape[1]
    start = cfg.n_dec_layers // 2 if layers_from is None else layers_from
    dev = enc_out.device
    if frame_counts is None:
        frame_counts = torch.full((b,), n_frames, dtype=torch.int32, device=dev)
    frame_counts = frame_counts.to(dev)
    vmask = (torch.arange(n_frames, device=dev)[None] < frame_counts[:, None]
             )[:, None, None, :]  # [B, 1, 1, F]
    cnt = frame_counts.clamp_min(1).float()[:, None, None, None]
    x = _embed_tokens(model, tokens)
    causal = _causal(s, dev)
    acc = torch.zeros((b, s, n_frames), dtype=torch.float32, device=dev)
    n_sel = 0
    scale = (cfg.dim // cfg.n_heads) ** -0.25
    for li, block in enumerate(dec.blocks):
        x = x + _self_attn(block.attn_ln(x), block.attn, cfg.n_heads, mask=causal)
        h = block.cross_attn_ln(x)
        ca = block.cross_attn
        qh = split_heads(ca.query(h), cfg.n_heads) * scale
        kh = split_heads(ca.key(enc_out), cfg.n_heads) * scale
        vh = split_heads(ca.value(enc_out), cfg.n_heads)
        scores = qh.float() @ kh.float().transpose(-1, -2)  # [B, H, S, F]
        if li >= start:
            wa = torch.softmax(scores.masked_fill(~vmask, _NEG_ATTN), dim=-1)
            mu = (wa * vmask).sum(dim=-1, keepdim=True) / cnt
            sd = torch.sqrt(torch.where(vmask, (wa - mu) ** 2, 0.0).sum(
                dim=-1, keepdim=True) / cnt) + 1e-9
            acc = acc + torch.where(vmask, (wa - mu) / sd, 0.0).sum(dim=1)
            n_sel += cfg.n_heads
        w = torch.softmax(scores, dim=-1).to(vh.dtype)
        x = x + ca.out(merge_heads(w @ vh))
        x = x + _mlp(block.mlp_ln(x), block)
    return acc / max(n_sel, 1)


@torch.no_grad()
def whisper_detect_language(model: Whisper, enc_out: torch.Tensor) -> torch.Tensor:
    """Language id per batch item: argmax over the language-token logits
    after SOT. Returns int64 [B] indices into tokenizer.LANGUAGES."""
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    tk = WhisperTokens(model.cfg.vocab_size)
    tokens = torch.full((enc_out.shape[0], 1), tk.sot, dtype=torch.long,
                        device=enc_out.device)
    logits = whisper_decode_full(model, tokens, enc_out)[:, 0]
    return logits[:, tk.lang_base:tk.lang_base + tk.n_langs].argmax(dim=-1)


@torch.no_grad()
def precompute_cross_kv(model: Whisper, enc_out: torch.Tensor, out=None):
    """Cross-attention K/V per layer from encoder states: 2x [L, B, S_enc, d],
    written into `out`'s two tensors where it is given."""
    blocks = model.decoder.blocks
    k_out, v_out = out if out is not None else (None, None)
    cross_k = torch.stack([b.cross_attn.key(enc_out) for b in blocks], out=k_out)
    cross_v = torch.stack([b.cross_attn.value(enc_out) for b in blocks], out=v_out)
    return cross_k, cross_v


def _residual_ln(x: torch.Tensor, ln: nn.LayerNorm, lin: nn.Module | None = None,
                 inp: torch.Tensor | None = None) -> torch.Tensor:
    """`x = x + lin(inp)` in place, then `ln(x)`: one `add_layer_norm` (with
    no `lin`, the LayerNorm alone). A float linear hands over its product
    before the bias and the bias; an int8 one adds its own bias."""
    if lin is None:
        return add_ln.add_layer_norm(x, ln.weight, ln.bias, ln.eps)
    if isinstance(lin, QuantLinear):
        return add_ln.add_layer_norm(x, ln.weight, ln.bias, ln.eps, y=lin(inp))
    return add_ln.add_layer_norm(x, ln.weight, ln.bias, ln.eps,
                                 y=F.linear(inp, lin.weight.to(inp.dtype)), b=lin.bias)


@dataclass
class DecodeBuffers:
    """A one-device decode's state: tokens [B, n] int64, the self caches
    [L, B, n, d] and the cross caches [L, B_cross, S_enc, d], which the decode
    fills and reorders in place; `pos`, the one-element device position the
    step reads; `attn_kernel` and `norm_kernel`, whether the step last run
    on them (or captured over them) launched the attention kernel and the
    add-and-LayerNorm kernel."""
    tokens: torch.Tensor
    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    pos: torch.Tensor
    attn_kernel: bool = False
    norm_kernel: bool = False

    def holds(self, tokens, *caches) -> bool:
        """Whether the tensors are these buffers: the caches (self_k, self_v,
        cross_k, cross_v) themselves, the tokens the buffer or its first
        columns."""
        return (tokens.data_ptr() == self.tokens.data_ptr()
                and tokens.stride() == self.tokens.stride()
                and all(c is b for c, b in zip(caches, (self.self_k, self.self_v,
                                                        self.cross_k, self.cross_v))))


def decode_buffers(model: Whisper, enc_out: torch.Tensor, rows: int, n: int) -> DecodeBuffers:
    """Uninitialised buffers for a decode of `rows` token rows over n
    positions and enc_out's windows [B_cross, S_enc, d], on its device."""
    (b, s_enc, d), layers = enc_out.shape, model.cfg.n_dec_layers

    def empty(*shape, dtype=enc_out.dtype):
        return torch.empty(shape, dtype=dtype, device=enc_out.device)
    return DecodeBuffers(empty(rows, n, dtype=torch.long), empty(layers, rows, n, d),
                         empty(layers, rows, n, d), empty(layers, b, s_enc, d),
                         empty(layers, b, s_enc, d), empty(1, dtype=torch.long))


@torch.no_grad()
def decoder_step(model: Whisper, cross_k, cross_v, tokens: torch.Tensor,
                 self_k: torch.Tensor, self_v: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """Run the decoder for the token at position `pos` of tokens [B, max_len].

    Writes this position's keys and values into self_k/self_v [L, B, n, d]
    (n >= max_len) in place, and attends over positions 0..pos of the cache
    (the kernel reads no further; the CPU's plain version masks the rest at
    -1e30, weights exactly 0, the JAX package's masking). cross_k/cross_v
    may carry fewer batch rows than tokens when several rows (beams) share
    one encoder state: each group of B/B_cross consecutive rows attends to
    one row. Returns logits [B, vocab] fp32. Counts
    `decode_attn_kernel_steps` and `decode_norm_kernel_steps` where the step
    launched the attention kernel and the add-and-LayerNorm kernel.

    Given the tensors of the `DecodeBuffers` of one of the model's
    `step_graph`s (on the card), the step is one replay of the CUDA graph
    captured over them, and the logits a copy that no later replay
    overwrites."""
    graph = step_graphs.holding(model, lambda b: b.holds(tokens, self_k, self_v,
                                                         cross_k, cross_v))
    if graph is None:
        buf = DecodeBuffers(tokens, self_k, self_v, cross_k, cross_v,
                            torch.tensor([pos], device=tokens.device))
        logits = _decoder_step_static(model, buf)
    else:
        buf = graph.buffers
        buf.pos.fill_(pos)
        logits = graph.replay(model)
    if buf.attn_kernel:
        METRICS.count("decode_attn_kernel_steps")
    if buf.norm_kernel:
        METRICS.count("decode_norm_kernel_steps")
    return logits


@torch.no_grad()
def _decoder_step_static(model: Whisper, buf: DecodeBuffers) -> torch.Tensor:
    """`decoder_step` on the buffers at `buf.pos`, with no shape that
    depends on it: the embeddings are indexed by it, the new keys and values
    go into the caches with `index_copy_`, and the self-attention reads it
    on the device. No host synchronisation: a CUDA graph captures it.

    Each residual branch's tail (its output linear's bias add and the
    residual add, x updated in place) and the LayerNorm after it are one
    `add_layer_norm`: 1 + 3 a layer. The cross-attention's K/V may carry
    fewer rows than the tokens: each group of B/B_cross consecutive rows
    (beams) attends to one row, whose bytes the kernel reads once for all."""
    cfg, dec, pos = model.cfg, model.decoder, buf.pos
    attn_launched, norm_launched = decode_attn.launches(), add_ln.launches()
    tok = buf.tokens.gather(1, pos.expand(buf.tokens.shape[0], 1))  # [B, 1]
    x = (dec.token_embedding.weight[tok]
         + dec.positional_embedding.index_select(0, pos)[None]).to(cfg.dtype)
    blocks = dec.blocks
    h = _residual_ln(x, blocks[0].attn_ln)
    for li, block in enumerate(blocks):
        at, ca = block.attn, block.cross_attn
        buf.self_k[li].index_copy_(1, pos, at.key(h))
        buf.self_v[li].index_copy_(1, pos, at.value(h))
        attn = decode_attn.decode_attention(at.query(h), buf.self_k[li], buf.self_v[li],
                                            cfg.n_heads, pos=pos)
        h = _residual_ln(x, block.cross_attn_ln, at.out, attn)
        cross = decode_attn.decode_attention(ca.query(h), buf.cross_k[li], buf.cross_v[li],
                                             cfg.n_heads)
        h = _residual_ln(x, block.mlp_ln, ca.out, cross)
        after = blocks[li + 1].attn_ln if li + 1 < len(blocks) else dec.ln
        h = _residual_ln(x, after, block.mlp[2], gelu(block.mlp[0](h)))
    buf.attn_kernel = decode_attn.launches() > attn_launched
    buf.norm_kernel = add_ln.launches() > norm_launched
    return _logits(model, h[:, 0])


def step_graph(model: Whisper, enc_out: torch.Tensor, rows: int, max_len: int):
    """A context that yields the model's graphed step for a decode of `rows`
    token rows up to `max_len` over enc_out's windows, the decode's alone
    until the block ends (models/step_graphs.py `hand_out`), or None where
    the step stays eager: off the current card, a decoder with int8 linears,
    or the shape's graph held by another decode. Its `buffers` are
    `DecodeBuffers` of max_len rounded up to a power of two, at most the
    decoder's context, so that decodes of near lengths share a graph: the
    tokens a decode works on are the buffer's first max_len columns."""
    if not (enc_out.is_cuda and enc_out.device.index == torch.cuda.current_device()
            and not any(isinstance(m, QuantLinear) for m in model.decoder.modules())):
        return nullcontext()
    n = min(1 << (max_len - 1).bit_length(),
            max(max_len, model.decoder.positional_embedding.shape[0]))
    return step_graphs.hand_out(model, (rows, n, tuple(enc_out.shape), enc_out.dtype),
                                lambda: decode_buffers(model, enc_out, rows, n),
                                _decoder_step_static, prefix="")


# -- tensor and pipeline parallelism ----------------------------------------------------


def _tp_dim(name: str) -> int | None:
    """The dimension of a Whisper parameter (torch's [out, in] layout) that
    a Megatron shard splits, the JAX package's `shard_whisper_specs` on the
    port's names: query/key/value/mlp.0 split the output features (column,
    with the query/value/mlp.0 biases), out/mlp.2 the input features (row;
    their biases are added once, after the sum), the decoder's token
    embedding its features (it is the input table and the tied output
    projection). Convs, layer norms, the positional embedding and the row
    biases replicate (None)."""
    if name == "decoder.token_embedding.weight":
        return 1
    if name.endswith(("query.weight", "key.weight", "value.weight", "mlp.0.weight",
                      "query.bias", "value.bias", "mlp.0.bias")):
        return 0
    if name.endswith(("out.weight", "mlp.2.weight")):
        return 1
    return None


def _whisper_shard(model: Whisper, index: int, tp: int, dev: torch.device) -> Whisper:
    """Shard `index` of `tp`: a Whisper module with the local widths on
    `dev`. On the model's own device its tensors are views of the model's."""
    with torch.device("meta"):
        shard = Whisper(model.cfg)
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        part = shard_slice(p.detach(), _tp_dim(name), index, tp).to(dev)
        setattr(shard.get_submodule(owner), leaf, nn.Parameter(part, requires_grad=False))
    if any(t.is_meta for t in shard.parameters()):
        raise ValueError("tensor-parallel shards need float linears (not int8)")
    return shard.eval()


class ShardLine(NamedTuple):
    """One line of a sharded Whisper: its config, the local shards in the
    line's order, and the line's collectives (parallel/collectives.py)."""
    cfg: WhisperConfig
    shards: list
    comm: object


class WhisperShards:
    """A Whisper cut into Megatron shards over `axis` of a mesh, once:
    `lines[i]` holds the local shards of the mesh's i-th line along the
    axis (all of them in one process; this rank's over a process group).
    Shards on one device share its copy."""

    def __init__(self, model: Whisper, mesh: Mesh, axis: str = "model"):
        tp = mesh.shape[axis]
        if model.cfg.n_heads % tp:
            raise ValueError(f"n_heads {model.cfg.n_heads} must divide tp size {tp}")
        self.cfg, self.mesh, self.axis, self.tp = model.cfg, mesh, axis, tp
        grid = mesh.place(lambda index, dev: _whisper_shard(model, index, tp, dev), axis)
        self.lines = [ShardLine(model.cfg, shards, comm) for shards, comm in
                      zip(mesh.line_entries(grid, axis), mesh.lines(axis))]


def shard_whisper(model: Whisper | WhisperShards, mesh: Mesh | None,
                  axis: str = "model") -> WhisperShards:
    """The model's Megatron shards over `axis` of `mesh` (n_heads must
    divide by the axis size: ValueError otherwise); shards pass through."""
    if isinstance(model, WhisperShards):
        return model
    if mesh is None:
        raise ValueError("an unsharded model needs a mesh")
    return WhisperShards(model, mesh, axis)


def _row_partial(h: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """A row-parallel linear's partial product, accumulated in fp32 and
    rounded to h's type; its bias is added after the sum."""
    return F.linear(h, lin.weight.to(h.dtype))


def _each_shard(line: ShardLine, fn, *per_shard) -> list:
    """fn(k, shard, *per_shard[..][k]) for every local shard k, each under
    its device."""
    out = []
    for k, (shard, dev) in enumerate(zip(line.shards, line.comm.devices)):
        with on(dev):
            out.append(fn(k, shard, *(xs[k] for xs in per_shard)))
    return out


@torch.no_grad()
def whisper_encode_tp(model: Whisper | WhisperShards, mel: torch.Tensor,
                      mesh: Mesh | None = None, axis: str = "model") -> torch.Tensor:
    """Tensor-parallel `whisper_encode`: Megatron column/row splits, K3 on
    each shard's local heads (n_heads / tp of them), one psum per residual
    branch, the row-parallel partials rounded to the compute type before it.
    model: a Whisper (sharded over `mesh` for this call) or its
    `WhisperShards`. The batch splits over the mesh's other axis. Returns
    [B, 1500, d] on mel's device."""
    shards = shard_whisper(model, mesh, axis)
    lines = shards.lines
    if mel.shape[0] % len(lines):
        raise ValueError(f"batch {mel.shape[0]} must divide by {len(lines)} mesh lines")
    per = mel.shape[0] // len(lines)
    outs = [_encode_tp_line(line, mel[i * per:(i + 1) * per])
            for i, line in enumerate(lines)]
    return torch.cat([o.to(mel.device) for o in outs])


def _encode_tp_line(line: ShardLine, mel: torch.Tensor) -> torch.Tensor:
    heads = line.cfg.n_heads // line.comm.size
    xs = _each_shard(line, lambda k, s: _encoder_stem(s, mel.to(line.comm.devices[k])))

    def attn_part(k, s, x, li):
        blk = s.encoder.blocks[li]
        h = blk.attn_ln(x)
        at = blk.attn
        b, n, _ = h.shape
        o = flash_attention(split_heads(at.query(h), heads), split_heads(at.key(h), heads),
                            split_heads(at.value(h), heads))
        return _row_partial(o.transpose(1, 2).reshape(b, n, -1), at.out)

    def mlp_part(k, s, x, li):
        blk = s.encoder.blocks[li]
        return _row_partial(gelu(blk.mlp[0](blk.mlp_ln(x))), blk.mlp[2])

    for li in range(line.cfg.n_enc_layers):
        for part, bias in ((attn_part, lambda blk: blk.attn.out.bias),
                           (mlp_part, lambda blk: blk.mlp[2].bias)):
            sums = line.comm.psum(_each_shard(line, lambda k, s, x: part(k, s, x, li), xs))
            xs = [x + sm + bias(s.encoder.blocks[li]).to(x.dtype)
                  for x, sm, s in zip(xs, sums, line.shards)]
    with on(line.comm.devices[0]):
        return line.shards[0].encoder.ln_post(xs[0])


@torch.no_grad()
def whisper_encode_pp(model: Whisper, mel: torch.Tensor, mesh: Mesh,
                      n_micro: int | None = None, axis: str = "model") -> torch.Tensor:
    """Pipeline-parallel `whisper_encode`: the encoder's layers span the
    stages of `axis` (parallel/pipeline.py's GPipe schedule, K3 in every
    layer on each microbatch); the conv stem, positions and the final layer
    norm run on the model's device. n_enc_layers must divide by the axis
    size."""
    x = _encoder_stem(model, mel)
    x = pipeline_transformer_layers(
        list(model.encoder.blocks), x,
        lambda block, h: _enc_layer(block, h, model.cfg.n_heads),
        mesh, axis=axis, n_micro=n_micro)
    return model.encoder.ln_post(x)


@torch.no_grad()
def precompute_cross_kv_tp(line: ShardLine, enc_out: torch.Tensor):
    """Each shard's cross-attention K/V: 2 lists of [L, B, S_enc, d/tp]."""
    def kv(k, s):
        e = enc_out.to(line.comm.devices[k])
        blocks = s.decoder.blocks
        return (torch.stack([b.cross_attn.key(e) for b in blocks]),
                torch.stack([b.cross_attn.value(e) for b in blocks]))
    ks, vs = zip(*_each_shard(line, kv))
    return list(ks), list(vs)


@torch.no_grad()
def decoder_step_tp(line: ShardLine, cross_k: list, cross_v: list,
                    tokens: torch.Tensor, self_k: list, self_v: list,
                    pos: int) -> torch.Tensor:
    """`decoder_step` over Megatron shards: per-shard lists of caches
    [L, B, max_len, d/tp] (written in place) and cross K/V; the token
    embedding's feature slices are all-gathered, each residual branch sums
    its row-parallel partials once (then + bias), and the tied output
    projection contracts each shard's feature slice of x and sums fp32
    partial logits. Activations stay full width on every shard, so the
    logits are the same on all. Returns logits [B, vocab] fp32 on tokens'
    device."""
    cfg, comm = line.cfg, line.comm
    heads = cfg.n_heads // comm.size
    b = tokens.shape[0]
    tok = tokens[:, pos]
    embs = comm.all_gather(_each_shard(
        line, lambda k, s: s.decoder.token_embedding.weight[tok.to(comm.devices[k])][:, None]))
    xs = [(e + s.decoder.positional_embedding[pos][None, None]).to(cfg.dtype)
          for e, s in zip(embs, line.shards)]

    def self_part(k, s, x, li):
        blk = s.decoder.blocks[li]
        at = blk.attn
        h = blk.attn_ln(x)
        self_k[k][li, :, pos] = at.key(h)[:, 0]
        self_v[k][li, :, pos] = at.value(h)[:, 0]
        attn = _attend(at.query(h), self_k[k][li, :, :pos + 1],
                       self_v[k][li, :, :pos + 1], heads)
        return _row_partial(attn, at.out)

    def cross_part(k, s, x, li):
        blk = s.decoder.blocks[li]
        q = blk.cross_attn.query(blk.cross_attn_ln(x))
        cross = decode_attn.decode_attention_plain(q, cross_k[k][li], cross_v[k][li], heads)
        return _row_partial(cross, blk.cross_attn.out)

    def mlp_part(k, s, x, li):
        blk = s.decoder.blocks[li]
        return _row_partial(gelu(blk.mlp[0](blk.mlp_ln(x))), blk.mlp[2])

    for li in range(cfg.n_dec_layers):
        for part, bias in ((self_part, lambda blk: blk.attn.out.bias),
                           (cross_part, lambda blk: blk.cross_attn.out.bias),
                           (mlp_part, lambda blk: blk.mlp[2].bias)):
            sums = comm.psum(_each_shard(line, lambda k, s, x: part(k, s, x, li), xs))
            xs = [x + (sm + bias(s.decoder.blocks[li]).to(x.dtype))
                  for x, sm, s in zip(xs, sums, line.shards)]

    def logits_part(k, s, x):
        emb = s.decoder.token_embedding.weight  # [vocab, d/tp]
        d_local = emb.shape[1]
        x_slice = s.decoder.ln(x)[:, 0, comm.indices[k] * d_local:(comm.indices[k] + 1) * d_local]
        return x_slice.float() @ emb.float().T
    return comm.psum(_each_shard(line, logits_part, xs))[0].to(tokens.device)
