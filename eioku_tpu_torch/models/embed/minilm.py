"""MiniLM-L6 sentence encoder as PyTorch modules (port of
eioku_tpu/models/embed/minilm.py).

all-MiniLM-L6-v2's architecture: BERT encoder, 6 layers, d 384, 12 heads of
32, FFN 1536, post-LN (eps 1e-12), exact erf GELU, mean pooling over the
attention mask, L2 normalisation. Modules are named after the HuggingFace
BERT keys (`embeddings.word_embeddings`, `encoder.layer.N.attention.self.
query`, ...), so a sentence-transformers or HF state dict loads by key name,
whatever its prefix (`0.auto_model.`, `bert.` or none).

Attention takes two routes, as in the JAX package: below S = 512 the plain
`mha` of models/layers.py; at S >= 512 ops/flash_attention.py (the
hand-written kernel K3 on the card, its plain version on the CPU) with
per-row lengths, on [B, H, S, 32] views of the [B, S, d] projections (no
transpose copy). The tokenizer pads to 256 on the indexing, query and rerank
paths, so those always take the plain route.

The activation type is the config's `compute_dtype`: the semantic index
runs bf16 on the card (the JAX indexing path's type) and fp32 on the CPU.
Embeddings, the embedding layer norm, pooling and normalisation are fp32.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from eioku_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    gelu_erf,
    jax_linear_state,
    jax_ln_state,
    load_state,
    mha,
    split_heads,
    xavier_,
)
from eioku_tpu_torch.ops.flash_attention import flash_attention

LN_EPS = 1e-12
FLASH_MIN_SEQ = 512  # sequences this long take K3


@dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    max_position: int = 512
    dim: int = 384
    n_layers: int = 6
    n_heads: int = 12
    ffn_dim: int = 1536
    type_vocab_size: int = 2
    # encoder-layer activation type: "bfloat16" on the card's indexing path,
    # "float32" on the CPU and for parity checks
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]


# -- modules (HF BERT names) -----------------------------------------------------------


class Embeddings(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_position, cfg.dim)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.dim)
        self.LayerNorm = LayerNorm(cfg.dim, eps=LN_EPS)


class SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = Linear(d, d)
        self.key = Linear(d, d)
        self.value = Linear(d, d)


class DenseLayerNorm(nn.Module):
    """A dense projection whose output is added to the residual and
    normalised (BERT's `attention.output` and `output`)."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.dense = Linear(d_in, d)
        self.LayerNorm = LayerNorm(d, eps=LN_EPS)


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self = SelfAttention(d)
        self.output = DenseLayerNorm(d, d)


class Intermediate(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.dense = Linear(d, ffn)


class Layer(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.attention = Attention(cfg.dim)
        self.intermediate = Intermediate(cfg.dim, cfg.ffn_dim)
        self.output = DenseLayerNorm(cfg.ffn_dim, cfg.dim)


class Encoder(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg) for _ in range(cfg.n_layers))


class MiniLM(nn.Module):
    """The parameter tree; the computation lives in the functions below."""

    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)


@torch.no_grad()
def init_trunk_(model: MiniLM, generator: torch.Generator) -> None:
    """Random weights with the JAX package's scheme (`init_minilm_params`):
    embeddings xavier x 0.05, xavier-uniform linears, zero biases, identity
    layer norms. The numbers differ from the JAX package's (the generators
    do): tests carry the JAX tree across with `from_jax_params` instead."""
    emb = model.embeddings
    for e in (emb.word_embeddings, emb.position_embeddings, emb.token_type_embeddings):
        xavier_(e.weight, tuple(e.weight.shape), generator, 0.05)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            xavier_(m.weight, (m.in_features, m.out_features), generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def init_minilm(cfg: MiniLMConfig, generator: torch.Generator,
                device: torch.device | str = "cpu") -> MiniLM:
    """Random weights drawn on the CPU from `generator`, then moved."""
    model = MiniLM(cfg)
    init_trunk_(model, generator)
    return model.to(device).eval().requires_grad_(False)


# -- forward ---------------------------------------------------------------------------


def encoder_layer(x: torch.Tensor, layer: Layer, n_heads: int, mask: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """One post-LN BERT layer. mask [B, 1, 1, S] bool; lengths [B] int32."""
    att = layer.attention
    q, k, v = att.self.query(x), att.self.key(x), att.self.value(x)
    b, s, d = q.shape
    if s >= FLASH_MIN_SEQ:
        # padding is contiguous at the end, so the key mask is a per-row
        # length; K3 reads the [B, S, H, hd] projections through their
        # strides and writes a [B, S, H, hd] buffer
        o = flash_attention(split_heads(q, n_heads), split_heads(k, n_heads),
                            split_heads(v, n_heads), lengths=lengths)
        attn = att.output.dense(o.transpose(1, 2).reshape(b, s, d))
    else:
        attn = att.output.dense(mha(q, k, v, n_heads, mask=mask))
    x = att.output.LayerNorm(x + attn)
    h = gelu_erf(layer.intermediate.dense(x))
    return layer.output.LayerNorm(x + layer.output.dense(h))


def encode(model: MiniLM, token_ids: torch.Tensor, attention_mask: torch.Tensor,
           type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """[B, S] ids -> last hidden states [B, S, d] in the compute type."""
    cfg, emb = model.cfg, model.embeddings
    s = token_ids.shape[1]
    types = emb.token_type_embeddings.weight[0][None, None] if type_ids is None \
        else emb.token_type_embeddings.weight[type_ids.long()]
    x = emb.word_embeddings.weight[token_ids.long()] \
        + emb.position_embeddings.weight[:s][None] + types
    x = emb.LayerNorm(x).to(cfg.dtype)
    mask = attention_mask[:, None, None, :].bool()
    lengths = attention_mask.sum(dim=-1).to(torch.int32)
    for layer in model.encoder.layer:
        x = encoder_layer(x, layer, cfg.n_heads, mask, lengths)
    return x


def embed(model: MiniLM, token_ids: torch.Tensor,
          attention_mask: torch.Tensor) -> torch.Tensor:
    """token_ids / mask [B, S] (on the model's device) -> L2-normalised
    sentence embeddings [B, dim] in fp32; differentiable (the fine-tune's
    forward, parallel/train.py)."""
    x = encode(model, token_ids, attention_mask).float()
    m = attention_mask[..., None].float()
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp_min(1e-9)


@torch.no_grad()
def minilm_embed(model: MiniLM, token_ids: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
    """`embed` without gradients: the indexing, query and rerank paths."""
    return embed(model, token_ids, attention_mask)


# -- weights ----------------------------------------------------------------------------


def module_keys(cls, cfg) -> list[str]:
    """The state-dict keys of `cls(cfg)`, built on the meta device."""
    with torch.device("meta"):
        return list(cls(cfg).state_dict())


def find_by_suffix(sd: dict, keys: list[str]) -> dict[str, np.ndarray]:
    """For each of the module's keys, the first entry of `sd` whose key ends
    with it (the JAX converter's rule), as fp32 numpy. Raises KeyError."""
    out = {}
    for key in keys:
        for k, v in sd.items():
            if k.endswith(key):
                v = v.float().numpy() if torch.is_tensor(v) else v
                out[key] = np.asarray(v, dtype=np.float32)
                break
        else:
            raise KeyError(key)
    return out


def convert_hf_state_dict(sd: dict, cfg: MiniLMConfig) -> dict[str, np.ndarray]:
    """A HuggingFace BERT-style state dict (all-MiniLM-L6-v2 naming,
    optionally '0.auto_model.' or 'bert.' prefixed; tensors or numpy) ->
    the port's state dict, matched by key suffix."""
    return find_by_suffix(sd, module_keys(MiniLM, cfg))


def from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """The JAX package's MiniLM parameter tree (numpy or JAX arrays) -> the
    port's state dict: linear w [in, out] -> weight [out, in], gamma / beta
    -> weight / bias."""
    sd = {"embeddings.word_embeddings.weight": np.asarray(params["tok_emb"], np.float32),
          "embeddings.position_embeddings.weight": np.asarray(params["pos_emb"],
                                                              np.float32),
          "embeddings.token_type_embeddings.weight": np.asarray(params["type_emb"],
                                                                np.float32)}
    jax_ln_state("embeddings.LayerNorm", params["emb_ln"], sd)
    for i, p in enumerate(params["layers"]):
        base = f"encoder.layer.{i}"
        jax_linear_state(f"{base}.attention.self.query", p["q"], sd)
        jax_linear_state(f"{base}.attention.self.key", p["k"], sd)
        jax_linear_state(f"{base}.attention.self.value", p["v"], sd)
        jax_linear_state(f"{base}.attention.output.dense", p["o"], sd)
        jax_ln_state(f"{base}.attention.output.LayerNorm", p["attn_ln"], sd)
        jax_linear_state(f"{base}.intermediate.dense", p["ffn1"], sd)
        jax_linear_state(f"{base}.output.dense", p["ffn2"], sd)
        jax_ln_state(f"{base}.output.LayerNorm", p["ffn_ln"], sd)
    return sd


def to_jax_params(model: MiniLM) -> dict:
    """The inverse of `from_jax_params`: the port's module -> the JAX
    package's MiniLM parameter tree of fp32 numpy arrays (linear weight
    [out, in] -> w [in, out]), which models/checkpoint.py saves as the
    native checkpoint."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}

    def lin(prefix: str) -> dict:
        return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
                "b": sd[f"{prefix}.bias"]}

    def ln(prefix: str) -> dict:
        return {"gamma": sd[f"{prefix}.weight"], "beta": sd[f"{prefix}.bias"]}

    tree = {"tok_emb": sd["embeddings.word_embeddings.weight"],
            "pos_emb": sd["embeddings.position_embeddings.weight"],
            "type_emb": sd["embeddings.token_type_embeddings.weight"],
            "emb_ln": ln("embeddings.LayerNorm"), "layers": []}
    for i in range(model.cfg.n_layers):
        base = f"encoder.layer.{i}"
        tree["layers"].append({
            "q": lin(f"{base}.attention.self.query"),
            "k": lin(f"{base}.attention.self.key"),
            "v": lin(f"{base}.attention.self.value"),
            "o": lin(f"{base}.attention.output.dense"),
            "attn_ln": ln(f"{base}.attention.output.LayerNorm"),
            "ffn1": lin(f"{base}.intermediate.dense"),
            "ffn2": lin(f"{base}.output.dense"),
            "ffn_ln": ln(f"{base}.output.LayerNorm"),
        })
    return tree


def read_native_npz(path: str) -> dict:
    """A native checkpoint (the JAX package's models/checkpoint.py
    `save_params`: one array per '/'-joined tree path, list indices as
    integers) -> the nested tree of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node, parts = tree, key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def load_minilm(cache_dir: str | None, cfg: MiniLMConfig | None = None, seed: int = 0,
                device: torch.device | str = "cpu") -> tuple[MiniLM, MiniLMConfig, bool]:
    """The JAX package's `load_minilm` order: `minilm-l6/native.npz` (or
    `minilm-native.npz`), then `minilm-l6/pytorch_model.bin` (or
    `pytorch_model.bin`), then `minilm-l6/weights.npz` (or `minilm.npz`);
    random init from `seed` otherwise. Returns (model, cfg, pretrained?)."""
    cfg = cfg or MiniLMConfig()
    model = init_minilm(cfg, torch.Generator().manual_seed(seed), device)
    sd = None
    if cache_dir:
        for loader, names in (
                (lambda p: from_jax_params(read_native_npz(p)),
                 ("minilm-l6/native.npz", "minilm-native.npz")),
                (lambda p: convert_hf_state_dict(
                    torch.load(p, map_location="cpu", weights_only=True), cfg),
                 ("minilm-l6/pytorch_model.bin", "pytorch_model.bin")),
                (lambda p: convert_hf_state_dict(dict(np.load(p)), cfg),
                 ("minilm-l6/weights.npz", "minilm.npz"))):
            path = next((os.path.join(cache_dir, n) for n in names
                         if os.path.isfile(os.path.join(cache_dir, n))), None)
            if path is not None:
                sd = loader(path)
                break
    if sd is None:
        return model, cfg, False
    return load_state(model, sd).eval(), cfg, True
