"""Cross-encoder reranker (ms-marco-MiniLM-L-6-v2) as PyTorch modules (port
of eioku_tpu/models/embed/cross_encoder.py).

One BERT pass over `[CLS] query [SEP] passage [SEP]` with token-type
segments, CLS pooling (dense + tanh) and a 1-logit classifier: HuggingFace
BertForSequenceClassification's layout (`bert.*` trunk, `bert.pooler.dense`,
`classifier`). The trunk, its layers and its two attention routes are
MiniLM's (minilm.py); the pooler and the classifier run in fp32.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from eioku_tpu_torch.models.embed.minilm import (
    MiniLM,
    MiniLMConfig,
    encode,
    find_by_suffix,
    from_jax_params as trunk_from_jax_params,
    init_trunk_,
    load_state,
    module_keys,
)
from eioku_tpu_torch.models.layers import Linear


@dataclass(frozen=True)
class CrossEncoderConfig(MiniLMConfig):
    """Same trunk dims as MiniLM-L6 (ms-marco-MiniLM-L-6-v2 IS that trunk)."""
    n_labels: int = 1


class Pooler(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense = Linear(d, d)


class CrossEncoder(MiniLM):
    def __init__(self, cfg: CrossEncoderConfig):
        super().__init__(cfg)
        self.pooler = Pooler(cfg.dim)
        self.classifier = Linear(cfg.dim, cfg.n_labels)


def init_cross_encoder(cfg: CrossEncoderConfig, generator: torch.Generator,
                       device: torch.device | str = "cpu") -> CrossEncoder:
    """Random weights with the JAX package's scheme
    (`init_cross_encoder_params`), drawn on the CPU from `generator`."""
    model = CrossEncoder(cfg)
    init_trunk_(model, generator)  # the pooler and the classifier are linears too
    return model.to(device).eval().requires_grad_(False)


@torch.no_grad()
def cross_encoder_score(model: CrossEncoder, token_ids: torch.Tensor,
                        type_ids: torch.Tensor,
                        attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] pair encodings -> [B] fp32 relevance logits (higher = more
    relevant)."""
    x = encode(model, token_ids, attention_mask, type_ids)
    cls = x[:, 0].float()  # CLS pooling, head at full precision
    pooled = torch.tanh(model.pooler.dense(cls))
    return model.classifier(pooled)[:, 0]


def convert_hf_cross_encoder(sd: dict, cfg: CrossEncoderConfig) -> dict[str, np.ndarray]:
    """A HuggingFace BertForSequenceClassification state dict -> the port's
    state dict, matched by key suffix (the 'bert.' prefix is transparent)."""
    return find_by_suffix(sd, module_keys(CrossEncoder, cfg))


def from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """The JAX package's cross-encoder tree -> the port's state dict."""
    sd = trunk_from_jax_params(params)
    for name in ("pooler.dense", "classifier"):
        p = params[name.split(".")[0]]
        sd[f"{name}.weight"] = np.asarray(p["w"], np.float32).T
        sd[f"{name}.bias"] = np.asarray(p["b"], np.float32)
    return sd


def load_cross_encoder(cache_dir: str | None, cfg: CrossEncoderConfig | None = None,
                       seed: int = 0, device: torch.device | str = "cpu"
                       ) -> tuple[CrossEncoder, CrossEncoderConfig, bool]:
    """`{cache_dir}/msmarco-minilm-l6/pytorch_model.bin` (or
    `cross-encoder/pytorch_model.bin`), then `msmarco-minilm-l6/weights.npz`
    (or `msmarco-minilm.npz`); random init from `seed` otherwise. Returns
    (model, cfg, pretrained?)."""
    cfg = cfg or CrossEncoderConfig()
    model = init_cross_encoder(cfg, torch.Generator().manual_seed(seed), device)
    if cache_dir:
        for names, read in (
                (("msmarco-minilm-l6/pytorch_model.bin", "cross-encoder/pytorch_model.bin"),
                 lambda p: torch.load(p, map_location="cpu", weights_only=True)),
                (("msmarco-minilm-l6/weights.npz", "msmarco-minilm.npz"),
                 lambda p: dict(np.load(p)))):
            for name in names:
                path = os.path.join(cache_dir, name)
                if os.path.isfile(path):
                    sd = convert_hf_cross_encoder(read(path), cfg)
                    return load_state(model, sd).eval(), cfg, True
    return model, cfg, False
