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
hand-written kernel K3 on the card, its plain version on the CPU). Decoder
attention is plain torch, as the JAX package leaves it outside any kernel.
`decoder_step` writes the new key/value into the caches IN PLACE (the JAX
version returns updated copies).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from eioku_tpu_torch.models.layers import LayerNorm, Linear, gelu
from eioku_tpu_torch.ops.flash_attention import flash_attention

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
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]


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


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.view(b, s, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _attend(q, k, v, n_heads: int, mask=None) -> torch.Tensor:
    """Decoder attention: q and k each scaled by hd^-0.25 in the activation
    type, scores and softmax in fp32, P cast to v's type, P V accumulated in
    fp32 and rounded to v's type."""
    scale = (q.shape[-1] // n_heads) ** -0.25
    qh = _split_heads(q, n_heads) * scale
    kh = _split_heads(k, n_heads) * scale
    vh = _split_heads(v, n_heads)
    scores = qh.float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_ATTN)
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    return _merge_heads(w @ vh)


def _attend_grouped(q, k, v, n_heads: int) -> torch.Tensor:
    """Cross-attention where G consecutive query rows share each key/value
    row: q [B*G, Sq, d]; k/v [B, Sk, d] -> [B*G, Sq, d]. Beams of one window
    attend to one copy of its encoder K/V."""
    b = k.shape[0]
    g = q.shape[0] // b
    hd = q.shape[-1] // n_heads
    scale = hd ** -0.25
    qh = _split_heads(q, n_heads) * scale  # [BG, H, Sq, hd]
    kh = _split_heads(k, n_heads) * scale  # [B, H, Sk, hd]
    vh = _split_heads(v, n_heads)
    qh = qh.reshape(b, g, n_heads, q.shape[1], hd)
    scores = torch.einsum("bghqd,bhkd->bghqk", qh.float(), kh.float())
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    out = torch.einsum("bghqk,bhkd->bghqd", w, vh)
    return _merge_heads(out.reshape(q.shape[0], n_heads, q.shape[1], hd))


def _self_attn(x, attn: MultiHeadAttention, n_heads: int, mask=None):
    q, k, v = attn.query(x), attn.key(x), attn.value(x)
    return attn.out(_attend(q, k, v, n_heads, mask))


def _self_attn_flash(x, attn: MultiHeadAttention, n_heads: int):
    """Encoder self-attention through K3. The projections are handed over
    as [B, S, H, D] views and the output comes back in that layout, so no
    head transpose is copied on the card."""
    q, k, v = attn.query(x), attn.key(x), attn.value(x)
    b, s, d = q.shape
    o = flash_attention(_split_heads(q, n_heads), _split_heads(k, n_heads),
                        _split_heads(v, n_heads))
    return attn.out(o.transpose(1, 2).reshape(b, s, d))


def _mlp(x, block: ResidualAttentionBlock) -> torch.Tensor:
    return block.mlp[2](gelu(block.mlp[0](x)))


# -- encoder -------------------------------------------------------------------------


def _conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """fp32 accumulation rounded to x's type, then + bias in x's type."""
    out = torch.nn.functional.conv1d(x, conv.weight.to(x.dtype), None,
                                     conv.stride, conv.padding)
    return out + conv.bias.to(x.dtype)[:, None]


@torch.no_grad()
def whisper_encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> encoder states [B, 1500, d] in the compute
    type."""
    cfg, enc = model.cfg, model.encoder
    x = mel.to(cfg.dtype)
    x = gelu(_conv1d(x, enc.conv1))
    x = gelu(_conv1d(x, enc.conv2)).transpose(1, 2)  # [B, S, d]
    pos = torch.from_numpy(sinusoids(x.shape[1], x.shape[2])).to(x.device, x.dtype)
    x = x + pos[None]
    for block in enc.blocks:
        x = x + _self_attn_flash(block.attn_ln(x), block.attn, cfg.n_heads)
        x = x + _mlp(block.mlp_ln(x), block)
    return enc.ln_post(x)


# -- decoder --------------------------------------------------------------------------


def _logits(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection, accumulated and returned in fp32."""
    return x.float() @ model.decoder.token_embedding.weight.float().T


@torch.no_grad()
def whisper_decode_full(model: Whisper, tokens: torch.Tensor,
                        enc_out: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] fp32 (full recompute, causal)."""
    cfg, dec = model.cfg, model.decoder
    s = tokens.shape[1]
    x = (dec.token_embedding.weight[tokens] + dec.positional_embedding[:s][None]
         ).to(cfg.dtype)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
    for block in dec.blocks:
        x = x + _self_attn(block.attn_ln(x), block.attn, cfg.n_heads, mask=causal)
        h = block.cross_attn_ln(x)
        ca = block.cross_attn
        x = x + ca.out(_attend(ca.query(h), ca.key(enc_out), ca.value(enc_out),
                               cfg.n_heads))
        x = x + _mlp(block.mlp_ln(x), block)
    return _logits(model, dec.ln(x))


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
def precompute_cross_kv(model: Whisper, enc_out: torch.Tensor):
    """Cross-attention K/V per layer from encoder states: 2x [L, B, S_enc, d]."""
    blocks = model.decoder.blocks
    cross_k = torch.stack([b.cross_attn.key(enc_out) for b in blocks])
    cross_v = torch.stack([b.cross_attn.value(enc_out) for b in blocks])
    return cross_k, cross_v


@torch.no_grad()
def decoder_step(model: Whisper, cross_k, cross_v, tokens: torch.Tensor,
                 self_k: torch.Tensor, self_v: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """Run the decoder for the token at position `pos` of tokens [B, max_len].

    Writes this position's keys and values into self_k/self_v [L, B, max_len,
    d] in place, and attends over positions 0..pos (the JAX version masks the
    rest with -1e30, whose weights are exactly 0). cross_k/cross_v may carry
    fewer batch rows than tokens when several rows (beams) share one encoder
    state: each group of B/B_cross consecutive rows attends to one row.
    Returns logits [B, vocab] fp32."""
    cfg, dec = model.cfg, model.decoder
    b = tokens.shape[0]
    x = (dec.token_embedding.weight[tokens[:, pos]][:, None, :]
         + dec.positional_embedding[pos][None, None]).to(cfg.dtype)
    for li, block in enumerate(dec.blocks):
        h = block.attn_ln(x)
        at = block.attn
        self_k[li, :, pos] = at.key(h)[:, 0]
        self_v[li, :, pos] = at.value(h)[:, 0]
        attn = _attend(at.query(h), self_k[li, :, :pos + 1],
                       self_v[li, :, :pos + 1], cfg.n_heads)
        x = x + at.out(attn)
        h = block.cross_attn_ln(x)
        ca = block.cross_attn
        q = ca.query(h)
        if cross_k.shape[1] == b:
            cross = _attend(q, cross_k[li], cross_v[li], cfg.n_heads)
        else:  # beams share encoder rows
            cross = _attend_grouped(q, cross_k[li], cross_v[li], cfg.n_heads)
        x = x + ca.out(cross)
        x = x + _mlp(block.mlp_ln(x), block)
    return _logits(model, dec.ln(x)[:, 0])

