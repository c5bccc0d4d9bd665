"""Silero-VAD checkpoints (port of eioku_tpu/models/vad/weights.py).

The Silero v5 export's names, one to one with the port's module but for the
LSTM's suffix:

  _model.stft.forward_basis_buffer        [2*bins, 1, n_fft]
  _model.encoder.{i}.reparam_conv.weight  [C_out, C_in, 3]   (and .bias)
  _model.decoder.rnn.weight_ih/weight_hh/bias_ih/bias_hh   -> ..._l0
  _model.decoder.decoder.2.weight         [1, H, 1]          (and .bias)

`from_jax_params` carries the JAX package's tree across. `load_vad` returns
None (the caller keeps the energy VAD) when there is no checkpoint, when it
does not load, or when the loaded model fails the behavioural check.
"""
from __future__ import annotations

import logging
import os
from functools import lru_cache

import numpy as np
import torch

from eioku_tpu_torch.models.layers import load_state
from eioku_tpu_torch.models.vad.model import SileroVad, VadConfig, vad_probs

log = logging.getLogger(__name__)

CHECKPOINT_NAME = "silero_vad.ckpt"
_LSTM = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def convert_silero_state_dict(sd: dict) -> dict[str, np.ndarray]:
    """A Silero v5 state dict (`_model.` prefix optional; tensors or numpy)
    -> the port's state dict."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("_model.")
        if k.startswith("decoder.rnn.") and k.rsplit(".", 1)[1] in _LSTM:
            k += "_l0"
        out[k] = v.detach().float().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v, np.float32)
    return out


def export_silero_state_dict(model: SileroVad) -> dict[str, torch.Tensor]:
    """The port's model -> Silero v5 names (`_model.` prefixed)."""
    return {"_model." + k.removesuffix("_l0"): v.detach().cpu().clone()
            for k, v in model.state_dict().items()}


def from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """The JAX package's VAD tree (stft_basis, encoder[i].{w [K, C_in, C_out],
    b}, lstm.{w_ih, w_hh, b_ih, b_hh}, out.{w [H, 1], b}) -> the port's state
    dict."""
    a = lambda x: np.asarray(x, np.float32)  # noqa: E731
    sd = {"stft.forward_basis_buffer": a(params["stft_basis"])[:, None, :]}
    for i, layer in enumerate(params["encoder"]):
        sd[f"encoder.{i}.reparam_conv.weight"] = a(layer["w"]).transpose(2, 1, 0)
        sd[f"encoder.{i}.reparam_conv.bias"] = a(layer["b"])
    for k in _LSTM:
        sd[f"decoder.rnn.{k}_l0"] = a(params["lstm"][k.replace("weight", "w")
                                                      .replace("bias", "b")])
    sd["decoder.decoder.2.weight"] = a(params["out"]["w"]).T[:, :, None]
    sd["decoder.decoder.2.bias"] = a(params["out"]["b"])
    return sd


def vad_from_state_dict(sd: dict[str, np.ndarray], cfg: VadConfig = VadConfig(),
                        device: torch.device | str = "cpu") -> SileroVad:
    """A port state dict -> a SileroVad in fp32 on `device`. Raises KeyError
    when a parameter is missing; extra keys are ignored, as the JAX
    converter ignores them."""
    return load_state(SileroVad(cfg).to(device), sd).eval()


@lru_cache(maxsize=4)
def load_vad(cache_dir: str | None, device: torch.device = torch.device("cpu"),
             cfg: VadConfig = VadConfig()) -> SileroVad | None:
    """{cache_dir}/silero_vad.ckpt as a model on `device`, or None when it is
    absent, does not load, or fails `sanity_check` (a corrupt or
    layout-mismatched checkpoint must degrade to the energy VAD, not fail
    every transcription). Cached per process, as the JAX package caches
    it."""
    if not cache_dir:
        return None
    path = os.path.join(cache_dir, CHECKPOINT_NAME)
    if not os.path.isfile(path):
        return None
    try:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
        log.info("loading silero VAD weights from %s", path)
        model = vad_from_state_dict(convert_silero_state_dict(sd), cfg, device)
        ok, p_sil, p_tone = sanity_check(model)
        if not ok:
            log.warning(
                "VAD checkpoint %s loaded but FAILED the behavioural sanity "
                "check (silence prob %.3f, speech-band tone prob %.3f); "
                "falling back to energy VAD", path, p_sil, p_tone)
            return None
        return model
    except Exception:
        log.warning("failed to load VAD checkpoint %s; falling back to energy "
                    "VAD", path, exc_info=True)
        return None


def sanity_check(model: SileroVad) -> tuple[bool, float, float]:
    """The JAX package's behavioural gate: near-zero probability on digital
    silence, and clearly more on a loud speech-band amplitude-modulated
    tone. Returns (ok, mean silence prob, mean tone prob)."""
    cfg = model.cfg
    dev = model.stft.forward_basis_buffer.device
    n = cfg.chunk * 32  # ~1 s of audio, a whole number of VAD chunks
    silence = np.zeros((1, n), np.float32)
    t = np.arange(n, dtype=np.float32) / cfg.sr
    # 220 Hz carrier + harmonics, 3 Hz syllabic AM: speech-band energy
    tone = ((0.4 * np.sin(2 * np.pi * 220 * t)
             + 0.2 * np.sin(2 * np.pi * 440 * t)
             + 0.1 * np.sin(2 * np.pi * 660 * t))
            * (0.55 + 0.45 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    p_sil = float(vad_probs(model, torch.from_numpy(silence).to(dev)).mean())
    p_tone = float(vad_probs(model, torch.from_numpy(tone[None]).to(dev)).mean())
    ok = p_sil < 0.35 and p_tone > p_sil + 0.05
    return ok, p_sil, p_tone
