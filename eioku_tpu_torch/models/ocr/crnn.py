"""CRNN text recognizer (VGG feature extractor + BiLSTM + CTC) as a PyTorch
module (port of eioku_tpu/models/ocr/crnn.py).

EasyOCR's None-VGG-BiLSTM-CTC generation-2 recognizer: grayscale 32xW crops
in [-1, 1] -> a VGG-style conv stack (conv4 and conv5 without bias, each
with a batch norm at eps 1e-5; conv6 2x2 VALID) -> two bidirectional LSTMs
with a linear projection each -> per-frame charset logits -> CTC greedy
collapse on the host.

Attribute names are EasyOCR's (`FeatureExtraction.ConvNet.N`,
`SequenceModeling.{0,1}.rnn` / `.linear`, `Prediction`), so its
checkpoints load by key names; the widths are read from the state dict.
The LSTMs are `nn.LSTM(bidirectional=True)` (gates i, f, g, o; both biases
added), run over the whole padded width: the batches are padded with -1.0
to the bucket width and the JAX package's scan reads the padding too, so
the sequences are not packed.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models.layers import (
    BatchNorm,
    Linear,
    RESNET_BN_EPS,
    init_weights,
    jax_bn_state,
    jax_conv_weight,
    load_by_key_names,
    max_pool,
)

# EasyOCR latin charset (generation 2), blank is index 0 for CTC.
LATIN_CHARSET = (
    "0123456789!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    "ÀÁÂÃÄÅÆÇÈÉÊËÌÍÎÏÐÑÒÓÔÕÖØÙÚÛÜÝÞßàáâãäåæçèéêëìíîïðñòóôõöøùúûüýþÿ"
    "ĀāĂăĄąĆćČčĎďĐđĒēĖėĘęĚěĞğĨĩĪīĮįİıĶķĹĺĻļĽľŁłŃńŅņŇňŒœŔŕŘřŚśŞşŠšŤťŨũŪūŮůŲų"
    "ŸŹźŻżŽžƏƠơƯưȘșȚțə"
)

IMG_H = 32
HIDDEN = 256
CHANNELS = 512

# ConvNet index of each conv (the JAX package's conv0..conv6) and of the
# batch norms after convs 4 and 5
_CONVS = [0, 3, 6, 8, 11, 14, 18]
_BNS = {11: 12, 14: 15}


def charset_size(charset: str = LATIN_CHARSET) -> int:
    return len(charset) + 1  # + CTC blank


class BidirectionalLSTM(nn.Module):
    def __init__(self, d_in: int, hidden: int, d_out: int):
        super().__init__()
        self.rnn = nn.LSTM(d_in, hidden, bidirectional=True, batch_first=True)
        self.linear = Linear(2 * hidden, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.rnn(x)[0])


class CRNN(nn.Module):
    def __init__(self, n_classes: int | None = None, channels: int = CHANNELS,
                 hidden: int = HIDDEN, generator: torch.Generator | None = None):
        super().__init__()
        n_classes = n_classes or charset_size()
        oc = [channels // 8, channels // 4, channels // 2, channels]
        plan = [(1, oc[0], 3), (oc[0], oc[1], 3), (oc[1], oc[2], 3), (oc[2], oc[2], 3),
                (oc[2], oc[3], 3), (oc[3], oc[3], 3), (oc[3], oc[3], 2)]
        convnet = nn.Sequential()
        for idx, (c_in, c_out, k) in zip(_CONVS, plan):
            convnet.add_module(str(idx), nn.Conv2d(c_in, c_out, k, padding=1 if k == 3 else 0,
                                                   bias=idx not in _BNS))
            if idx in _BNS:
                convnet.add_module(str(_BNS[idx]), BatchNorm(c_out, eps=RESNET_BN_EPS))
        self.FeatureExtraction = nn.Module()
        self.FeatureExtraction.ConvNet = convnet
        self.SequenceModeling = nn.Sequential(BidirectionalLSTM(channels, hidden, hidden),
                                              BidirectionalLSTM(hidden, hidden, hidden))
        self.Prediction = Linear(hidden, n_classes)
        if generator is not None:
            init_weights(self, generator)
            _init_lstms(self, generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, 32, W] -> [B, T, channels], T = W/4 - 1."""
        net = self.FeatureExtraction.ConvNet._modules

        def conv(idx, t):
            t = net[str(idx)](t)
            if idx in _BNS:
                t = net[str(_BNS[idx])](t)
            return F.relu(t)

        x = max_pool(conv(0, x), 2, stride=2)
        x = max_pool(conv(3, x), 2, stride=2)
        x = conv(8, conv(6, x))
        x = max_pool(x, (2, 1), stride=(2, 1), padding="VALID")
        x = conv(14, conv(11, x))
        x = max_pool(x, (2, 1), stride=(2, 1), padding="VALID")
        x = conv(18, x)  # [B, C, 1, T]
        return x[:, :, 0].transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 1, 32, W] in [-1, 1] -> logits [B, T, n_classes]."""
        return self.Prediction(self.SequenceModeling(self.features(x)))


@torch.no_grad()
def _init_lstms(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's LSTM init: Kaiming-normal input and recurrent
    weights (fan-in = their input width), zero biases."""
    for m in model.modules():
        if isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith("weight"):
                    p.copy_(torch.randn(p.shape, generator=generator)
                            * math.sqrt(2.0 / p.shape[1]))
                else:
                    p.zero_()


def ctc_greedy_decode(logits: np.ndarray, charset: str = LATIN_CHARSET
                      ) -> list[tuple[str, float]]:
    """logits [B, T, C] -> [(text, confidence)] via best-path decoding."""
    out = []
    probs = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs /= probs.sum(axis=-1, keepdims=True)
    ids = logits.argmax(axis=-1)
    for b in range(logits.shape[0]):
        chars, confs = [], []
        prev = -1
        for t in range(ids.shape[1]):
            i = int(ids[b, t])
            if i != prev and i != 0:
                chars.append(charset[i - 1] if i - 1 < len(charset) else "")
                confs.append(float(probs[b, t, i]))
            prev = i
        text = "".join(chars).strip()
        out.append((text, float(np.mean(confs)) if confs else 0.0))
    return out


# -- weights ---------------------------------------------------------------------


def load_easyocr_recognizer(sd: dict) -> CRNN:
    """An EasyOCR None-VGG-BiLSTM-CTC state dict (keys optionally
    'module.'-prefixed) -> the module, fp32 on the CPU; the class count,
    the conv width and the LSTM width come from its shapes."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    shape = lambda k: tuple(np.shape(sd[k]))  # noqa: E731
    model = CRNN(n_classes=shape("Prediction.weight")[0],
                 channels=shape("FeatureExtraction.ConvNet.18.weight")[0],
                 hidden=shape("SequenceModeling.0.rnn.weight_hh_l0")[1])
    return load_by_key_names(model, sd, "CRNN").eval()


def from_jax_params(tree: dict) -> CRNN:
    """The JAX package's CRNN tree (`init_crnn_params`,
    `convert_easyocr_recognizer`: HWIO convs, LSTM wi / wh [in, 4h], linear
    w [in, out]) -> the module."""
    sd: dict = {}
    for i, idx in enumerate(_CONVS):
        p = tree[f"conv{i}"]
        sd[f"FeatureExtraction.ConvNet.{idx}.weight"] = jax_conv_weight(p["w"])
        if "b" in p:
            sd[f"FeatureExtraction.ConvNet.{idx}.bias"] = np.asarray(p["b"], np.float32)
    for bn, idx in (("bn4", 12), ("bn5", 15)):
        jax_bn_state(f"FeatureExtraction.ConvNet.{idx}", tree[bn], sd)
    for li in (1, 2):
        base = f"SequenceModeling.{li - 1}"
        for direction, suffix in (("fw", ""), ("bw", "_reverse")):
            p = tree[f"lstm{li}_{direction}"]
            for ours, theirs in (("wi", "weight_ih"), ("wh", "weight_hh")):
                sd[f"{base}.rnn.{theirs}_l0{suffix}"] = np.asarray(p[ours], np.float32).T
            for ours, theirs in (("bi", "bias_ih"), ("bh", "bias_hh")):
                sd[f"{base}.rnn.{theirs}_l0{suffix}"] = np.asarray(p[ours], np.float32)
        proj = tree[f"lstm{li}_proj"]
        sd[f"{base}.linear.weight"] = np.asarray(proj["w"], np.float32).T
        sd[f"{base}.linear.bias"] = np.asarray(proj["b"], np.float32)
    sd["Prediction.weight"] = np.asarray(tree["fc"]["w"], np.float32).T
    sd["Prediction.bias"] = np.asarray(tree["fc"]["b"], np.float32)
    return load_easyocr_recognizer(sd)
