"""CLIP (ViT-B/32) dual encoder as PyTorch modules (port of
eioku_tpu/models/clip/model.py).

  vision: 32x32 stride-32 patch conv (no bias) -> [CLS] + 49 tokens +
          learned positions -> pre-LN -> 12 pre-LN blocks (width 768, 12
          heads, QuickGELU) -> post-LN on CLS -> projection (no bias) -> 512
  text:   BPE ids (context 77) + learned positions -> 12 pre-LN causal
          blocks (width 512, 8 heads, QuickGELU) -> final LN -> the EOT
          token (argmax of the ids: EOT is the largest id, and argmax takes
          the first maximum, so padding after it never wins) -> projection
Both outputs are L2-normalised; similarity is the cosine.

Modules carry HuggingFace `CLIPModel` key names (`vision_model.*`,
`text_model.*`, `visual_projection`, `text_projection`; HF spells the
vision pre-LN `pre_layrnorm`), so its state dict loads through
`convert_hf_state_dict`. Attention is the plain `mha` of models/layers.py
with the JAX package's -1e30 causal mask (S = 50 and 77; the JAX towers do
not take the flash kernel either). The blocks run in the config's
`compute_dtype` ("float32" by default, the JAX config's); the pooled
post-LN, the projection and the normalisation run in fp32. Images arrive
as [B, H, W, 3] from `preprocess_images` (host bicubic resize and centre
crop, CLIP's normalisation).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    jax_linear_state,
    jax_ln_state,
    load_state,
    mha,
    quick_gelu,
    xavier_,
)

# HF CLIPProcessor normalization constants (image_processing_clip.py)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
LN_EPS = 1e-5


@dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    # vision tower (ViT-B/32)
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    # text tower
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp: int = 2048
    compute_dtype: str = "float32"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]


# -- modules (HF names) ---------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, hidden), Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(d, eps=LN_EPS)
        self.self_attn = Attention(d)
        self.layer_norm2 = LayerNorm(d, eps=LN_EPS)
        self.mlp = Mlp(d, mlp)

    def forward(self, x: torch.Tensor, n_heads: int,
                mask: torch.Tensor | None) -> torch.Tensor:
        a = self.self_attn
        h = self.layer_norm1(x)
        x = x + a.out_proj(mha(a.q_proj(h), a.k_proj(h), a.v_proj(h), n_heads, mask=mask))
        h = self.layer_norm2(x)
        return x + self.mlp.fc2(quick_gelu(self.mlp.fc1(h)))


class Encoder(nn.Module):
    def __init__(self, d: int, mlp: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(Block(d, mlp) for _ in range(n_layers))


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w = cfg.vision_width
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.patch_embedding = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(cfg.n_patches + 1, w)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w = cfg.vision_width
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(w, eps=LN_EPS)
        self.encoder = Encoder(w, cfg.vision_mlp, cfg.vision_layers)
        self.post_layernorm = LayerNorm(w, eps=LN_EPS)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.position_embedding = nn.Embedding(cfg.context_length, cfg.text_width)


class TextTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(cfg.text_width, cfg.text_mlp, cfg.text_layers)
        self.final_layer_norm = LayerNorm(cfg.text_width, eps=LN_EPS)


class CLIP(nn.Module):
    """The parameter tree; the computation lives in the functions below."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionTransformer(cfg)
        self.text_model = TextTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.vision_width, cfg.embed_dim, bias=False)
        self.text_projection = nn.Linear(cfg.text_width, cfg.embed_dim, bias=False)


@torch.no_grad()
def init_clip(cfg: ClipConfig, generator: torch.Generator,
              device: torch.device | str = "cpu") -> CLIP:
    """Random weights with the JAX package's scheme (`init_clip_params`):
    Xavier-uniform linears, projections and patch conv, zero biases,
    identity layer norms, CLS and positions Xavier x 0.02 (text positions x
    0.01), token embeddings Xavier x 0.02. The numbers differ from the JAX
    package's (the generators do): tests carry the JAX tree across with
    `from_jax_params`."""
    model = CLIP(cfg)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            xavier_(m.weight, (m.in_features, m.out_features), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    vis, txt = model.vision_model.embeddings, model.text_model.embeddings
    p, vw, tw = cfg.patch_size, cfg.vision_width, cfg.text_width
    xavier_(vis.class_embedding, (vw,), generator, 0.02)
    xavier_(vis.patch_embedding.weight, (p * p * 3, vw), generator)
    xavier_(vis.position_embedding.weight, (cfg.n_patches + 1, vw), generator, 0.02)
    xavier_(txt.token_embedding.weight, (cfg.vocab_size, tw), generator, 0.02)
    xavier_(txt.position_embedding.weight, (cfg.context_length, tw), generator, 0.01)
    return model.to(device).eval().requires_grad_(False)


# -- forward -------------------------------------------------------------------------


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-9)


@torch.no_grad()
def clip_encode_image(model: CLIP, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] fp32, resized and CLIP-normalised
    (`preprocess_images`), on the model's device -> L2-normalised
    embeddings [B, embed_dim] in fp32."""
    cfg, vm = model.cfg, model.vision_model
    emb = vm.embeddings
    dtype = cfg.dtype
    x = F.conv2d(images.permute(0, 3, 1, 2).to(dtype), emb.patch_embedding.weight.to(dtype),
                 stride=cfg.patch_size)
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)  # [B, patches, W], row-major patches
    cls = emb.class_embedding.to(dtype).expand(b, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight.to(dtype)[None]
    x = vm.pre_layrnorm(x)
    for blk in vm.encoder.layers:
        x = blk(x, cfg.vision_heads, None)
    pooled = vm.post_layernorm(x[:, 0].float())
    return _normalize(pooled @ model.visual_projection.weight.float().T)


@torch.no_grad()
def clip_encode_text(model: CLIP, token_ids: torch.Tensor) -> torch.Tensor:
    """token_ids [B, context_length] (SOT ... EOT, 0-padded) on the model's
    device -> L2-normalised embeddings [B, embed_dim] in fp32."""
    cfg, tm = model.cfg, model.text_model
    emb = tm.embeddings
    ids = token_ids.long()
    s = ids.shape[1]
    x = (emb.token_embedding.weight[ids] + emb.position_embedding.weight[:s][None]) \
        .to(cfg.dtype)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=ids.device))[None, None]
    for blk in tm.encoder.layers:
        x = blk(x, cfg.text_heads, causal)
    x = tm.final_layer_norm(x.float())
    pooled = x[torch.arange(x.shape[0], device=ids.device), torch.argmax(ids, dim=-1)]
    return _normalize(pooled @ model.text_projection.weight.float().T)


def preprocess_images(frames: list[np.ndarray], cfg: ClipConfig) -> np.ndarray:
    """uint8 RGB frames (any geometry) -> [B, S, S, 3] float32, resized
    shortest-side + center-cropped + normalized exactly like HF's
    CLIPImageProcessor (bicubic)."""
    import cv2
    size = cfg.image_size
    out = np.empty((len(frames), size, size, 3), np.float32)
    for i, f in enumerate(frames):
        h, w = f.shape[:2]
        scale = size / min(h, w)
        nh, nw = max(size, int(round(h * scale))), max(size, int(round(w * scale)))
        r = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_CUBIC)
        top, left = (nh - size) // 2, (nw - size) // 2
        out[i] = r[top:top + size, left:left + size].astype(np.float32) / 255.0
    return (out - IMAGE_MEAN) / IMAGE_STD


# -- weights ---------------------------------------------------------------------------


def convert_hf_state_dict(sd: dict, cfg: ClipConfig) -> dict[str, np.ndarray]:
    """A HuggingFace CLIPModel state dict (openai/clip-vit-base-* naming;
    tensors or numpy) -> the port's state dict: `pre_layernorm` is renamed
    to HF's `pre_layrnorm`, keys the model does not have (`logit_scale`,
    `position_ids`) are dropped. Raises KeyError on a missing key."""
    sd = {k.replace("vision_model.pre_layernorm", "vision_model.pre_layrnorm"): v
          for k, v in sd.items()}
    with torch.device("meta"):
        keys = list(CLIP(cfg).state_dict())
    out = {}
    for k in keys:
        v = sd[k]
        out[k] = v.float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)
    out["vision_model.embeddings.class_embedding"] = \
        out["vision_model.embeddings.class_embedding"].reshape(-1)
    return out


def from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """The JAX package's CLIP tree (`init_clip_params`,
    `convert_hf_state_dict`: linear w [in, out], HWIO patch conv) -> the
    port's state dict."""
    vis, txt = params["visual"], params["text"]
    sd = {"vision_model.embeddings.class_embedding": np.asarray(vis["cls"], np.float32),
          "vision_model.embeddings.patch_embedding.weight": np.ascontiguousarray(
              np.transpose(np.asarray(vis["patch"], np.float32), (3, 2, 0, 1))),
          "vision_model.embeddings.position_embedding.weight": np.asarray(vis["pos"],
                                                                          np.float32),
          "visual_projection.weight": np.asarray(vis["proj"], np.float32).T,
          "text_model.embeddings.token_embedding.weight": np.asarray(txt["tok_emb"],
                                                                     np.float32),
          "text_model.embeddings.position_embedding.weight": np.asarray(txt["pos"],
                                                                        np.float32),
          "text_projection.weight": np.asarray(txt["proj"], np.float32).T}
    jax_ln_state("vision_model.pre_layrnorm", vis["pre_ln"], sd)
    jax_ln_state("vision_model.post_layernorm", vis["post_ln"], sd)
    jax_ln_state("text_model.final_layer_norm", txt["final_ln"], sd)
    for tower, blocks in (("vision_model", vis["blocks"]), ("text_model", txt["blocks"])):
        for i, p in enumerate(blocks):
            b = f"{tower}.encoder.layers.{i}"
            jax_ln_state(f"{b}.layer_norm1", p["ln1"], sd)
            jax_ln_state(f"{b}.layer_norm2", p["ln2"], sd)
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                 ("o", "out_proj")):
                jax_linear_state(f"{b}.self_attn.{theirs}", p[ours], sd)
            jax_linear_state(f"{b}.mlp.fc1", p["fc1"], sd)
            jax_linear_state(f"{b}.mlp.fc2", p["fc2"], sd)
    return sd


def load_clip(cache_dir: str | None, cfg: ClipConfig | None = None, seed: int = 0,
              device: torch.device | str = "cpu") -> tuple[CLIP, ClipConfig, bool]:
    """Load from `{cache_dir}/clip-vit-b32/pytorch_model.bin` (or
    `clip.bin`) when present; random init from `seed` otherwise. Returns
    (model on `device`, cfg, pretrained?)."""
    cfg = cfg or ClipConfig()
    model = init_clip(cfg, torch.Generator().manual_seed(seed), device)
    if cache_dir:
        for name in ("clip-vit-b32/pytorch_model.bin", "clip.bin"):
            path = os.path.join(cache_dir, name)
            if os.path.isfile(path):
                sd = torch.load(path, map_location="cpu", weights_only=True)
                return load_state(model, convert_hf_state_dict(sd, cfg)), cfg, True
    return model, cfg, False
