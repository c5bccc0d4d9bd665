"""Whisper checkpoints -> the port's `Whisper` module (port of
eioku_tpu/models/whisper/weights.py).

The module's parameter names are OpenAI's (`encoder.blocks.N.attn.query.
weight`, ...), so an OpenAI state dict loads one to one; HuggingFace names
(`model.encoder.layers.N.self_attn.q_proj.weight`, ...) are renamed to them.
Both are torch layouts already (conv1d [out, in, k], linear [out, in]).
`from_jax_params` carries the JAX package's parameter tree across: conv1d
WIO [k, in, out] -> [out, in, k], linear [in, out] -> [out, in].
"""
from __future__ import annotations

import re

import numpy as np
import torch

from eioku_tpu_torch.models.whisper.model import Whisper, WhisperConfig

# HF sub-names -> OpenAI sub-names, applied to the part after the layer index
_HF_LAYER = (
    ("self_attn.q_proj", "attn.query"), ("self_attn.k_proj", "attn.key"),
    ("self_attn.v_proj", "attn.value"), ("self_attn.out_proj", "attn.out"),
    ("encoder_attn.q_proj", "cross_attn.query"),
    ("encoder_attn.k_proj", "cross_attn.key"),
    ("encoder_attn.v_proj", "cross_attn.value"),
    ("encoder_attn.out_proj", "cross_attn.out"),
    ("self_attn_layer_norm", "attn_ln"),
    ("encoder_attn_layer_norm", "cross_attn_ln"),
    ("final_layer_norm", "mlp_ln"), ("fc1", "mlp.0"), ("fc2", "mlp.2"),
)
_HF_TOP = {
    "encoder.layer_norm.weight": "encoder.ln_post.weight",
    "encoder.layer_norm.bias": "encoder.ln_post.bias",
    "decoder.layer_norm.weight": "decoder.ln.weight",
    "decoder.layer_norm.bias": "decoder.ln.bias",
    "decoder.embed_tokens.weight": "decoder.token_embedding.weight",
    "decoder.embed_positions.weight": "decoder.positional_embedding",
}
# buffers and tied copies a checkpoint may carry that the module recomputes
_IGNORED = ("encoder.positional_embedding", "encoder.embed_positions.weight",
            "proj_out.weight")


def _openai_name(key: str) -> str:
    key = key.removeprefix("model.")
    if key in _HF_TOP:
        return _HF_TOP[key]
    m = re.match(r"(encoder|decoder)\.layers\.(\d+)\.(.+)$", key)
    if m is None:
        return key
    side, idx, rest = m.groups()
    for hf, oa in _HF_LAYER:
        if rest.startswith(hf + "."):
            rest = oa + rest[len(hf):]
            break
    return f"{side}.blocks.{idx}.{rest}"


def load_state_dict(model: Whisper, sd: dict) -> Whisper:
    """Load an OpenAI- or HF-named state dict (tensors or numpy arrays) into
    `model`, converting to each parameter's type and device. Raises KeyError
    naming any parameter the state dict lacks; extra keys are ignored, as the
    JAX package's converter ignores them."""
    renamed = {_openai_name(k): v for k, v in sd.items()}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(renamed))
    if missing:
        raise KeyError(f"whisper state dict lacks {len(missing)} parameters, "
                       f"e.g. {missing[:3]}")
    with torch.no_grad():
        for name, p in params.items():
            v = renamed[name]
            v = v.float() if torch.is_tensor(v) else torch.from_numpy(
                np.array(v, dtype=np.float32))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(v.shape)}, "
                                 f"model {tuple(p.shape)}")
            p.copy_(v.to(p.device, p.dtype))
    return model


def _empty_model(cfg: WhisperConfig, device) -> Whisper:
    with torch.device("meta"):
        model = Whisper(cfg)
    return model.to_empty(device=device)


def from_jax_params(tree: dict, cfg: WhisperConfig,
                    device: torch.device | str = "cpu") -> Whisper:
    """The JAX package's Whisper parameter tree (numpy or array leaves, as
    `init_whisper_params` builds it) -> a `Whisper` module in fp32."""
    a = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    sd: dict[str, np.ndarray] = {}

    def lin(prefix: str, p: dict) -> None:
        sd[f"{prefix}.weight"] = a(p["w"]).T
        if "b" in p:
            sd[f"{prefix}.bias"] = a(p["b"])

    def ln(prefix: str, p: dict) -> None:
        sd[f"{prefix}.weight"] = a(p["gamma"])
        sd[f"{prefix}.bias"] = a(p["beta"])

    def block(prefix: str, p: dict, cross: bool) -> None:
        for jax_name, oa in (("attn", "attn"), ("cross", "cross_attn")):
            if jax_name == "cross" and not cross:
                continue
            for proj, name in (("q", "query"), ("k", "key"), ("v", "value"),
                               ("o", "out")):
                lin(f"{prefix}.{oa}.{name}", p[jax_name][proj])
        ln(f"{prefix}.attn_ln", p["ln1"])
        if cross:
            ln(f"{prefix}.cross_attn_ln", p["ln_cross"])
        ln(f"{prefix}.mlp_ln", p["ln2"])
        lin(f"{prefix}.mlp.0", p["mlp1"])
        lin(f"{prefix}.mlp.2", p["mlp2"])

    enc, dec = tree["enc"], tree["dec"]
    for name in ("conv1", "conv2"):
        sd[f"encoder.{name}.weight"] = np.transpose(a(enc[name]["w"]), (2, 1, 0))
        sd[f"encoder.{name}.bias"] = a(enc[name]["b"])
    for i, layer in enumerate(enc["layers"]):
        block(f"encoder.blocks.{i}", layer, cross=False)
    ln("encoder.ln_post", enc["ln_post"])
    sd["decoder.token_embedding.weight"] = a(dec["tok_emb"])
    sd["decoder.positional_embedding"] = a(dec["pos_emb"])
    for i, layer in enumerate(dec["layers"]):
        block(f"decoder.blocks.{i}", layer, cross=True)
    ln("decoder.ln", dec["ln"])
    return load_state_dict(_empty_model(cfg, device), sd)


def load_whisper_checkpoint(path: str, cfg: WhisperConfig,
                            device: torch.device | str = "cpu") -> Whisper:
    """`.npz` (numpy arrays) or `.pt`/`.bin` (torch.save of a state dict, or
    of a dict holding one under `model_state_dict`, OpenAI's layout), in
    OpenAI or HF naming -> a `Whisper` module in fp32 on `device`."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.get("model_state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k: v for k, v in sd.items() if _openai_name(k) not in _IGNORED}
    return load_state_dict(_empty_model(cfg, device), sd)
