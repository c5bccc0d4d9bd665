"""Model voice activity detection, Silero-VAD-v5-style (port of
eioku_tpu/models/vad/model.py).

STFT magnitudes (one matmul of the framed audio against a real/imaginary
DFT basis), four conv1d + ReLU layers with symmetric (k-1)//2 zero padding
over all frames at once, a mean over each chunk's 4 frames, an LSTM across
the 32 ms chunks (`nn.LSTM`: the i, f, g, o gate order of the JAX cell,
both biases), then a linear readout and a sigmoid: one speech probability
per 512 samples.

Module names follow the Silero v5 export where they can (`stft.
forward_basis_buffer`, `encoder.{i}.reparam_conv`, `decoder.decoder.2`);
the LSTM's are nn.LSTM's (`decoder.rnn.weight_ih_l0`, ...), which weights.py
maps from Silero's `decoder.rnn.weight_ih`. The model only runs with a
checkpoint: random weights would gate speech arbitrarily, so the caller
keeps the energy VAD without one (ml/audio_io.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BUCKET_SECONDS = 30  # vad_activity pads the audio to a multiple of this


@dataclass(frozen=True, eq=True)
class VadConfig:
    sr: int = 16000
    chunk: int = 512          # samples per VAD decision (32 ms @ 16 kHz)
    n_fft: int = 256
    hop: int = 128            # -> 4 STFT frames per chunk
    channels: tuple[int, ...] = (128, 64, 64, 128)
    hidden: int = 128         # LSTM cell width

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def frames_per_chunk(self) -> int:
        return self.chunk // self.hop


def dft_basis(n_fft: int) -> np.ndarray:
    """Real-DFT analysis basis [2*(n_fft//2+1), n_fft]: real rows then imag
    rows (the layout of Silero's stft forward_basis_buffer)."""
    bins = n_fft // 2 + 1
    n = np.arange(n_fft)
    k = np.arange(bins)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)]).astype(np.float32)


class _Stft(nn.Module):
    def __init__(self, cfg: VadConfig):
        super().__init__()
        self.register_buffer("forward_basis_buffer",
                             torch.from_numpy(dft_basis(cfg.n_fft))[:, None, :])


class _EncoderLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.reparam_conv = nn.Conv1d(c_in, c_out, 3, padding=1)


class _Decoder(nn.Module):
    def __init__(self, cfg: VadConfig):
        super().__init__()
        self.rnn = nn.LSTM(cfg.channels[-1], cfg.hidden, batch_first=True)
        # index 2 as in Silero's Sequential(Dropout, ReLU, Conv1d, Sigmoid);
        # the JAX model reads the LSTM state linearly, with no ReLU
        self.decoder = nn.ModuleList([nn.Identity(), nn.Identity(),
                                      nn.Conv1d(cfg.hidden, 1, 1)])


class SileroVad(nn.Module):
    def __init__(self, cfg: VadConfig = VadConfig()):
        super().__init__()
        self.cfg = cfg
        self.stft = _Stft(cfg)
        c_in, enc = cfg.n_bins, []
        for c_out in cfg.channels:
            enc.append(_EncoderLayer(c_in, c_out))
            c_in = c_out
        self.encoder = nn.ModuleList(enc)
        self.decoder = _Decoder(cfg)


@torch.no_grad()
def init_vad(generator: torch.Generator, cfg: VadConfig = VadConfig(),
             device: torch.device | str = "cpu") -> SileroVad:
    """Random weights from an explicit generator: Kaiming-normal convs and
    LSTM matrices (std sqrt(2 / fan_in)), zero biases."""
    model = SileroVad(cfg)
    for name, p in model.named_parameters():
        if name.endswith("bias") or "bias_" in name:
            p.zero_()
        else:
            fan_in = p.shape[1] * (p.shape[2] if p.dim() == 3 else 1)
            p.copy_(torch.randn(p.shape, generator=generator) * math.sqrt(2.0 / fan_in))
    return model.to(device).eval()


def _stft_mag(audio: torch.Tensor, cfg: VadConfig, basis: torch.Tensor) -> torch.Tensor:
    """audio [B, S] (S a multiple of hop) -> magnitudes [B, T, n_bins]."""
    x = F.pad(audio, (0, cfg.n_fft - cfg.hop))  # every hop gets a frame
    frames = x.unfold(1, cfg.n_fft, cfg.hop)  # [B, S // hop, n_fft]
    spec = frames @ basis.T
    re, im = spec.chunk(2, dim=-1)
    return torch.sqrt(re * re + im * im + 1e-9)


@torch.no_grad()
def vad_probs(model: SileroVad, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, S] or [S] fp32 in [-1, 1], on the model's device -> speech
    probability [B, n_chunks], one per cfg.chunk samples (S is right-padded
    to a multiple of the chunk)."""
    cfg = model.cfg
    if audio.dim() == 1:
        audio = audio[None]
    b, s = audio.shape
    n_chunks = -(-s // cfg.chunk)
    audio = F.pad(audio.float(), (0, n_chunks * cfg.chunk - s))
    x = _stft_mag(audio, cfg, model.stft.forward_basis_buffer[:, 0]).transpose(1, 2)
    for layer in model.encoder:
        x = F.relu(layer.reparam_conv(x))  # [B, C, T]
    x = x.transpose(1, 2).reshape(b, n_chunks, cfg.frames_per_chunk, -1).mean(dim=2)
    hs, _ = model.decoder.rnn(x)  # zero initial state
    out = model.decoder.decoder[2]
    logits = hs @ out.weight[0, :, 0] + out.bias[0]
    return torch.sigmoid(logits)


def vad_activity(model: SileroVad, audio: np.ndarray, threshold: float = 0.5,
                 frame_ms: int = 30) -> np.ndarray:
    """Boolean activity per frame_ms frame of a 1-D waveform: the interface
    of ml.audio_io.energy_vad.

    The waveform is zero-padded to the next BUCKET_SECONDS multiple first, as
    the JAX package pads it to share compiles: the conv stack's symmetric
    padding gives each frame a few frames of lookahead, so the last real
    chunks see that zero tail, and keeping the bucket keeps their
    probabilities the JAX package's."""
    cfg = model.cfg
    if len(audio) == 0:
        return np.zeros(0, bool)
    bucket = cfg.sr * BUCKET_SECONDS
    wav = np.zeros(-(-len(audio) // bucket) * bucket, np.float32)
    wav[:len(audio)] = audio
    dev = model.stft.forward_basis_buffer.device
    probs = vad_probs(model, torch.from_numpy(wav).to(dev)[None])[0].cpu().numpy()
    active_chunks = probs[:-(-len(audio) // cfg.chunk)] >= threshold
    frame = int(cfg.sr * frame_ms / 1000)
    n_frames = len(audio) // frame
    if n_frames == 0:
        return np.zeros(0, bool)
    chunk_idx = np.minimum(np.arange(n_frames) * frame // cfg.chunk,
                           len(active_chunks) - 1)
    return active_chunks[chunk_idx]
