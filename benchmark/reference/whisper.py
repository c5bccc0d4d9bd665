"""Whisper as published (openai/whisper), in plain PyTorch: the log-mel front
end, the encoder, a full causal decoder pass over given tokens, and the
decoding rules that shape the log-probabilities of a transcription's tokens.
No kernel, no cache, no batching of beams; float32 unless a float8 `Arith`
is given (the control).

Departures from the published model and tool, each also in the port:
- the 8 dB dynamic-range clamp takes the maximum of each 30 s window;
- every special token from <|startoftranscript|> to <|nocaptions|> is
  suppressed at each step (OpenAI suppresses that range without the
  language tokens).
The port computes GELU with the tanh approximation; this reference keeps
the published exact GELU, so that difference is part of what it measures.

Parameters use OpenAI's checkpoint names (`encoder.blocks.N.attn.query.
weight`, ...). Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Arith

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_AUDIO_CTX = 1500
N_TEXT_CTX = 448
LN_EPS = 1e-5
BLANK = 220  # byte-BPE " "
MAX_INITIAL_TIMESTAMP_INDEX = 50  # 1.0 s in 0.02 s steps
# the multilingual vocabulary's `suppress_tokens` (Whisper's generation
# config): symbols and sounds that never occur in speech
NON_SPEECH = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
)


class Specials:
    """The multilingual tokenizer's special ids: <|endoftext|> 50257, then
    <|startoftranscript|>, the languages (100 from large-v3's 51,866-entry
    vocabulary on, 99 before), translate, transcribe, startoflm,
    startofprev, nocaptions, notimestamps and the timestamps."""

    def __init__(self, vocab: int):
        self.eot = 50257
        self.sot = 50258
        n_langs = 100 if vocab >= 51866 else 99
        self.no_speech = self.sot + 1 + n_langs + 4
        self.no_timestamps = self.no_speech + 1
        self.ts_begin = self.no_timestamps + 1
        self.vocab = vocab


# -- front end -------------------------------------------------------------------------


def _slaney_mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels, htk=False,
    norm="slaney"), computed in float64."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        m * (200.0 / 3))

    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    diff = np.diff(pts)
    ramps = pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / diff[:-1, None]
    upper = ramps[2:] / diff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int, arith: Arith | None = None) -> torch.Tensor:
    """audio [B, T] -> [B, n_mels, T // 160]: torch.stft with a periodic Hann
    window and reflect padding, the last frame dropped, power through the
    Slaney filterbank, log10 clamped at 1e-10 and to 8 below each window's
    maximum, then (x + 4) / 4."""
    arith = arith or Arith()
    audio = audio.float()
    window = torch.hann_window(N_FFT, periodic=True, device=audio.device)
    spec = torch.stft(audio, N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2  # [B, freqs, frames]
    filters = torch.from_numpy(_slaney_mel_filters(n_mels)).float().to(audio.device)
    mel = arith.matmul(filters, power) if arith.quant else filters @ power
    log_spec = torch.clamp(mel, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


# -- transformer ---------------------------------------------------------------------------


def sinusoids(length: int, channels: int) -> torch.Tensor:
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).float()


class Whisper:
    """p: OpenAI-named parameters in float32 on one device."""

    def __init__(self, p: dict[str, torch.Tensor], n_heads: int, arith: Arith | None = None):
        self.p = p
        self.h = n_heads
        self.a = arith or Arith()
        self.enc_layers = _count(p, "encoder.blocks.")
        self.dec_layers = _count(p, "decoder.blocks.")

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"],
                            LN_EPS)

    def _lin(self, x, name):
        return self.a.linear(x, self.p[name + ".weight"], self.p.get(name + ".bias"))

    def _attn(self, q, k, v, causal: bool = False):
        b, sq, d = q.shape
        hd = d // self.h
        qh = q.view(b, sq, self.h, hd).transpose(1, 2)
        kh = k.view(b, k.shape[1], self.h, hd).transpose(1, 2)
        vh = v.view(b, v.shape[1], self.h, hd).transpose(1, 2)
        s = self.a.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
        if causal:
            s = s.masked_fill(~torch.ones(sq, sq, dtype=torch.bool, device=s.device).tril(),
                              float("-inf"))
        w = torch.softmax(s, dim=-1)
        return self.a.matmul(w, vh).transpose(1, 2).reshape(b, sq, d)

    def _mha(self, x, prefix, kv=None, causal=False):
        src = x if kv is None else kv
        q = self._lin(x, prefix + ".query")
        k = self._lin(src, prefix + ".key")
        v = self._lin(src, prefix + ".value")
        return self._lin(self._attn(q, k, v, causal), prefix + ".out")

    def _mlp(self, x, prefix):
        return self._lin(F.gelu(self._lin(x, prefix + ".mlp.0")), prefix + ".mlp.2")

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, 3000] -> [B, 1500, d]."""
        p = self.p
        x = F.gelu(self.a.conv1d(mel, p["encoder.conv1.weight"], p["encoder.conv1.bias"], 1, 1))
        x = F.gelu(self.a.conv1d(x, p["encoder.conv2.weight"], p["encoder.conv2.bias"], 2, 1))
        x = x.transpose(1, 2)
        x = x + sinusoids(x.shape[1], x.shape[2]).to(x.device)
        for i in range(self.enc_layers):
            b = f"encoder.blocks.{i}"
            x = x + self._mha(self._ln(x, b + ".attn_ln"), b + ".attn")
            x = x + self._mlp(self._ln(x, b + ".mlp_ln"), b)
        return self._ln(x, "encoder.ln_post")

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """tokens [B, S], enc [B, 1500, d] -> logits [B, S, vocab], a full
        causal pass (no cache)."""
        p = self.p
        emb = p["decoder.token_embedding.weight"]
        x = emb[tokens] + p["decoder.positional_embedding"][:tokens.shape[1]]
        for i in range(self.dec_layers):
            b = f"decoder.blocks.{i}"
            x = x + self._mha(self._ln(x, b + ".attn_ln"), b + ".attn", causal=True)
            x = x + self._mha(self._ln(x, b + ".cross_attn_ln"), b + ".cross_attn", kv=enc)
            x = x + self._mlp(self._ln(x, b + ".mlp_ln"), b)
        return self.a.linear(self._ln(x, "decoder.ln"), emb)


def _count(p: dict, prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in p if k.startswith(prefix)})


# -- decoding rules -----------------------------------------------------------------------


def suppress_mask(sp: Specials, timestamps: bool, device) -> torch.Tensor:
    m = torch.zeros(sp.vocab, dtype=torch.bool, device=device)
    m[sp.sot:sp.no_speech + 1] = True
    m[sp.no_timestamps] = True
    if not timestamps:
        m[sp.ts_begin:] = True
    m[list(NON_SPEECH)] = True
    return m


def ruled_distributions(logits: torch.Tensor, row: list[int], n_init: int, sp: Specials,
                        timestamps: bool, ambiguity: float = 0.0):
    """For each generated token of `row` (after the n_init prompt tokens, up
    to and including the first <|endoftext|>): (the token, [log-probability
    vectors over the vocabulary]) under the published decoding rules:
    suppressed tokens, blank and <|endoftext|> barred at the first
    position, and with timestamps the timestamp rules (pairs, non-
    decreasing, the first at most 1.0 s, a timestamp forced when the
    timestamps' total probability beats every text token). Where that last
    rule's margin is within `ambiguity` nats, rounding decides it: both
    vectors are given, forced and not. logits [S, vocab] of the row."""
    inf = float("-inf")
    always = suppress_mask(sp, timestamps, logits.device)
    for pos in range(n_init - 1, len(row) - 1):
        lg = logits[pos].float().masked_fill(always, inf)
        seq = row[n_init:pos + 1]
        if not seq:
            lg[BLANK] = inf
            lg[sp.eot] = inf
        out = [lg]
        if timestamps:
            last_ts = len(seq) >= 1 and seq[-1] >= sp.ts_begin
            penult_ts = len(seq) < 2 or seq[-2] >= sp.ts_begin
            if last_ts:
                if penult_ts:
                    lg[sp.ts_begin:] = inf
                else:
                    lg[:sp.eot] = inf
            stamps = [t for t in seq if t >= sp.ts_begin]
            if stamps:
                floor = stamps[-1] if (last_ts and not penult_ts) else stamps[-1] + 1
                lg[sp.ts_begin:floor] = inf
            if not seq:
                lg[:sp.ts_begin] = inf
                lg[sp.ts_begin + MAX_INITIAL_TIMESTAMP_INDEX + 1:] = inf
            lp = torch.log_softmax(lg, dim=-1)
            margin = float(torch.logsumexp(lp[sp.ts_begin:], dim=-1) - lp[:sp.ts_begin].max())
            forced = lg.clone()
            forced[:sp.ts_begin] = inf
            if margin > ambiguity:
                out = [forced]
            elif margin >= -ambiguity:
                out = [lg, forced]
        tok = row[pos + 1]
        yield tok, [torch.log_softmax(v, dim=-1) for v in out]
        if tok == sp.eot:
            return


def ruled_logprobs(logits: torch.Tensor, row: list[int], n_init: int, sp: Specials,
                   timestamps: bool) -> list[float]:
    """The log-probability of each generated token of `row` under the rules
    (`ruled_distributions`, every decision taken as computed here)."""
    return [float(vecs[0][tok])
            for tok, vecs in ruled_distributions(logits, row, n_init, sp, timestamps)]
