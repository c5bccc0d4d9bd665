"""Whisper log-mel spectrogram frontend (port of eioku_tpu/models/whisper/mel.py).

16 kHz PCM, STFT n_fft=400 hop=160 with a periodic Hann window, slaney-scale
mel filterbank (80 bins; 128 for large-v3), log10 with the dynamic range
clamped to [max-8, max], then (x+4)/4. The STFT is a framed matmul against the
same windowed DFT bases the JAX package builds (not torch.stft, whose
rounding differs), so both packages compute the same sums.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 400
HOP = 160
SAMPLE_RATE = 16000


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (librosa default, used by Whisper's filterbank)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized triangular filterbank [n_mels, n_fft//2 + 1]."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lower, center, upper = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lower) / max(center - lower, 1e-10)
        down = (upper - fft_freqs) / max(upper - center, 1e-10)
        fb[i] = np.maximum(0, np.minimum(up, down))
        fb[i] *= 2.0 / (upper - lower)  # slaney: constant energy per band
    return fb.astype(np.float32)


@lru_cache(maxsize=1)
def dft_bases(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases: [n_fft, n_freqs] cos/sin matrices."""
    n_freqs = n_fft // 2 + 1
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    angle = -2.0 * np.pi * t * k / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, T] float32 (T a multiple of HOP) -> log-mel [B, n_mels, T//HOP]
    on audio's device.

    Matches openai/whisper: reflect-pad n_fft//2, drop the last frame, clamp
    to 8 dB of dynamic range, scale (x+4)/4."""
    dev = audio.device
    audio = audio.float()
    n_frames = audio.shape[1] // HOP  # whisper drops the trailing frame
    x = F.pad(audio[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, N_FFT, HOP)[:, :n_frames]  # [B, frames, n_fft]
    cos_b, sin_b = (torch.from_numpy(m).to(dev) for m in dft_bases())
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im  # [B, frames, freqs]
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)  # [mels, freqs]
    mel = torch.einsum("btk,mk->bmt", power, fb)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec,
                             log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0
