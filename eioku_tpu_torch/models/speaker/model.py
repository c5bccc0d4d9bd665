"""ECAPA-TDNN speaker embedder (port of eioku_tpu/models/speaker/model.py).

speechbrain/spkrec-ecapa-voxceleb's architecture at its published widths
(EcapaConfig's defaults): a TDNN stem (k 5), three SE-Res2Net blocks with
dilations 2/3/4 (Res2Net scale 8, squeeze-excitation over the time mean),
multi-layer feature aggregation, attentive statistics pooling with global
context, batch norm and a k-1 convolution to the 192-d embedding, L2
normalised. Activations are [B, C, T] (torch's conv layout).

Rounding follows the JAX package's: each convolution accumulates in fp32,
rounds to the activation type, then adds its bias in that type; TDNN blocks
run conv -> ReLU -> batch norm (`BatchNorm`: scale and shift from fp32
statistics); the attention softmax runs in fp32. Padding is the JAX
package's "SAME" with zeros, d(k-1)/2 a side, NOT speechbrain's reflect
padding, so a speechbrain checkpoint computes what the JAX package computes
with it.

Module names are speechbrain's (`blocks.0.conv.conv.weight`,
`blocks.1.res2net_block.blocks.0.norm.norm.running_mean`, `asp.tdnn...`,
`asp_bn.norm...`, `fc.conv...`), so its embedding_model.ckpt loads by key
name. `from_jax_params` carries the JAX package's tree across.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models.layers import (
    BatchNorm,
    jax_bn_state,
    load_by_key_names,
)
from eioku_tpu_torch.models.whisper.mel import dft_bases, mel_filterbank

log = logging.getLogger(__name__)

N_FFT = 400  # 25 ms window @ 16 kHz
HOP = 160    # 10 ms
BN_EPS = 1e-5
CHECKPOINT_NAME = "ecapa_voxceleb.ckpt"


@dataclass(frozen=True)
class EcapaConfig:
    n_mels: int = 80
    channels: int = 1024          # speechbrain voxceleb release uses 1024
    res2net_scale: int = 8
    se_channels: int = 128
    attention_channels: int = 128
    mfa_channels: int = 1536
    embed_dim: int = 192
    dilations: tuple[int, ...] = (2, 3, 4)
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]


def fbank(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, T] fp32 @ 16 kHz -> log-mel fbanks [B, frames, n_mels] with
    per-window mean normalisation (speechbrain Fbank + InputNormalization),
    on audio's device."""
    dev = audio.device
    frames = audio.float().unfold(1, N_FFT, HOP)  # [B, 1 + (T - 400) // 160, 400]
    cos_b, sin_b = (torch.from_numpy(m).to(dev) for m in dft_bases(N_FFT))
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im
    mel = power @ torch.from_numpy(mel_filterbank(n_mels, N_FFT)).to(dev).T
    logmel = torch.log(mel.clamp_min(1e-10))
    return logmel - logmel.mean(dim=1, keepdim=True)


# -- modules (speechbrain names) ------------------------------------------------------


class Conv(nn.Module):
    """speechbrain's Conv1d wrapper (key prefix `.conv`); "SAME" zero
    padding."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, dilation=dilation,
                              padding=dilation * (k - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        out = F.conv1d(x, c.weight.to(x.dtype), None, padding=c.padding,
                       dilation=c.dilation)
        return out + c.bias.to(x.dtype)[:, None]


class Norm(nn.Module):
    """speechbrain's BatchNorm1d wrapper (key prefix `.norm`)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = BatchNorm(c, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class TDNNBlock(nn.Module):
    """conv -> ReLU -> batch norm (speechbrain's order)."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, dilation)
        self.norm = Norm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    def __init__(self, c: int, scale: int, dilation: int):
        super().__init__()
        cs = c // scale
        self.scale = scale
        self.blocks = nn.ModuleList(TDNNBlock(cs, cs, 3, dilation)
                                    for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = x.chunk(self.scale, dim=1)
        ys, y = [chunks[0]], None
        for i in range(1, self.scale):
            y = self.blocks[i - 1](chunks[i] if i == 1 else chunks[i] + y)
            ys.append(y)
        return torch.cat(ys, dim=1)


class SEBlock(nn.Module):
    def __init__(self, c: int, se: int):
        super().__init__()
        self.conv1 = Conv(c, se)
        self.conv2 = Conv(se, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=2, keepdim=True)
        s = torch.sigmoid(self.conv2(F.relu(self.conv1(s))))
        return x * s


class SERes2NetBlock(nn.Module):
    def __init__(self, c: int, scale: int, se: int, dilation: int):
        super().__init__()
        self.tdnn1 = TDNNBlock(c, c)
        self.res2net_block = Res2NetBlock(c, scale, dilation)
        self.tdnn2 = TDNNBlock(c, c)
        self.se_block = SEBlock(c, se)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.se_block(self.tdnn2(self.res2net_block(self.tdnn1(x)))) + x


class AttentiveStatisticsPooling(nn.Module):
    def __init__(self, c: int, attention: int):
        super().__init__()
        self.tdnn = TDNNBlock(c * 3, attention)
        self.conv = Conv(attention, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> [B, 2C, 1]: attention-weighted mean and std, the
        attention seeing each frame beside the global mean and std."""
        mean = x.mean(dim=2, keepdim=True)
        std = torch.sqrt(x.var(dim=2, unbiased=False, keepdim=True) + 1e-10)
        ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        attn = self.conv(torch.tanh(self.tdnn(ctx)))
        attn = torch.softmax(attn.float(), dim=2).to(x.dtype)
        mu = (attn * x).sum(dim=2)
        sg = torch.sqrt(((attn * x * x).sum(dim=2) - mu * mu).clamp_min(1e-10))
        return torch.cat([mu, sg], dim=1)[:, :, None]


class ECAPA(nn.Module):
    def __init__(self, cfg: EcapaConfig = EcapaConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.blocks = nn.ModuleList(
            [TDNNBlock(cfg.n_mels, c, 5)]
            + [SERes2NetBlock(c, cfg.res2net_scale, cfg.se_channels, d)
               for d in cfg.dilations])
        self.mfa = TDNNBlock(c * len(cfg.dilations), cfg.mfa_channels)
        self.asp = AttentiveStatisticsPooling(cfg.mfa_channels, cfg.attention_channels)
        self.asp_bn = Norm(cfg.mfa_channels * 2)
        self.fc = Conv(cfg.mfa_channels * 2, cfg.embed_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """fbanks [B, T, n_mels] -> unnormalised embeddings [B, embed_dim]
        in the compute type."""
        x = self.blocks[0](feats.to(self.cfg.dtype).transpose(1, 2))
        hidden = []
        for block in self.blocks[1:]:
            x = block(x)
            hidden.append(x)
        x = self.mfa(torch.cat(hidden, dim=1))
        return self.fc(self.asp_bn(self.asp(x)))[:, :, 0]


@torch.no_grad()
def ecapa_embed(model: ECAPA, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, T] fp32 @ 16 kHz on the model's device -> L2-normalised
    embeddings [B, embed_dim] fp32."""
    emb = model(fbank(audio, model.cfg.n_mels)).float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-10)


# -- weights --------------------------------------------------------------------------


@torch.no_grad()
def init_ecapa(cfg: EcapaConfig, generator: torch.Generator,
               device: torch.device | str = "cpu") -> ECAPA:
    """Random weights from an explicit generator: Kaiming-normal convs (std
    sqrt(2 / (C_in k))), zero biases, identity batch norms; weights in fp32
    (the compute type applies to activations)."""
    model = ECAPA(cfg)
    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            fan_in = m.in_channels * m.kernel_size[0]
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_in))
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d | nn.BatchNorm2d):
            m.reset_parameters()
    return model.to(device).eval()


def from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """The JAX package's ECAPA tree -> the port's state dict: conv WIO
    [K, C_in, C_out] -> [C_out, C_in, K], batch norm {gamma, beta, mean,
    var} -> weight, bias, running_mean, running_var."""
    sd: dict[str, np.ndarray] = {}

    def conv(prefix: str, p: dict) -> None:
        sd[f"{prefix}.conv.weight"] = np.ascontiguousarray(
            np.asarray(p["w"], np.float32).transpose(2, 1, 0))
        sd[f"{prefix}.conv.bias"] = np.asarray(p["b"], np.float32)

    def tdnn(prefix: str, p: dict) -> None:
        conv(f"{prefix}.conv", p)
        jax_bn_state(f"{prefix}.norm.norm", p["bn"], sd)

    tdnn("blocks.0", params["stem"])
    for i, p in enumerate(params["blocks"], start=1):
        tdnn(f"blocks.{i}.tdnn1", p["tdnn1"])
        for j, r in enumerate(p["res2"]):
            tdnn(f"blocks.{i}.res2net_block.blocks.{j}", r)
        tdnn(f"blocks.{i}.tdnn2", p["tdnn2"])
        conv(f"blocks.{i}.se_block.conv1", p["se1"])
        conv(f"blocks.{i}.se_block.conv2", p["se2"])
    tdnn("mfa", params["mfa"])
    tdnn("asp.tdnn", params["asp_tdnn"])
    conv("asp.conv", params["asp_conv"])
    jax_bn_state("asp_bn.norm", params["asp_bn"], sd)
    conv("fc", params["fc"])
    return sd


def ecapa_from_state_dict(sd: dict, cfg: EcapaConfig = EcapaConfig(),
                          device: torch.device | str = "cpu") -> ECAPA:
    """A state dict in speechbrain's names (tensors or numpy; batch norms'
    `num_batches_tracked` optional) -> an ECAPA in fp32 on `device`."""
    return load_by_key_names(ECAPA(cfg), sd, "ECAPA").to(device).eval()


def load_ecapa(cache_dir: str | None, cfg: EcapaConfig = EcapaConfig(), seed: int = 0,
               device: torch.device | str = "cpu") -> ECAPA:
    """{cache_dir}/ecapa_voxceleb.ckpt (a speechbrain state dict, loaded by
    key name) when present, else random init from `seed`."""
    if cache_dir:
        path = os.path.join(cache_dir, CHECKPOINT_NAME)
        if os.path.isfile(path):
            sd = torch.load(path, map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
            log.info("loading ECAPA weights from %s", path)
            return ecapa_from_state_dict(sd, cfg, device)
    log.warning("no ECAPA checkpoint found; using random init")
    return init_ecapa(cfg, torch.Generator().manual_seed(seed), device)
