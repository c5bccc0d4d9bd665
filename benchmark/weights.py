"""Seeded weights, made by the benchmark and handed alike to the port and to
the references.

Each model's weights come from one draw of a `torch.Generator` on the
device they are made on, in the type they are served in (bfloat16 for
Whisper, float32 for MiniLM's checkpoint), then scaled tensor by tensor:
xavier-uniform matrices, small random biases, layer norms near identity.
The token embeddings are scaled so that logits and embeddings spread as a
trained model's do: Whisper's logits by about 1 (the port's own 0.02-scaled
init gives every token nearly -ln 51,866), MiniLM's embeddings so that texts
are told apart (the port's 0.05-scaled init puts every text at cosine
~0.998 of every other).
"""
from __future__ import annotations

import math

import torch


def whisper_shapes(d: int, n_mels: int, enc_layers: int, dec_layers: int,
                   vocab: int) -> list[tuple[str, tuple[int, ...], str]]:
    """OpenAI's parameter names, shapes and init kinds for one Whisper."""
    out = [("encoder.conv1.weight", (d, n_mels, 3), "conv"), ("encoder.conv1.bias", (d,), "bias"),
           ("encoder.conv2.weight", (d, d, 3), "conv"), ("encoder.conv2.bias", (d,), "bias")]

    def attn(prefix: str) -> None:
        for proj in ("query", "key", "value", "out"):
            out.append((f"{prefix}.{proj}.weight", (d, d), "linear"))
            if proj != "key":  # Whisper's keys have no bias
                out.append((f"{prefix}.{proj}.bias", (d,), "bias"))

    def ln(prefix: str) -> None:
        out.extend([(f"{prefix}.weight", (d,), "ln_weight"), (f"{prefix}.bias", (d,), "bias")])

    def block(prefix: str, cross: bool) -> None:
        attn(prefix + ".attn")
        ln(prefix + ".attn_ln")
        if cross:
            attn(prefix + ".cross_attn")
            ln(prefix + ".cross_attn_ln")
        out.extend([(f"{prefix}.mlp.0.weight", (4 * d, d), "linear"),
                    (f"{prefix}.mlp.0.bias", (4 * d,), "bias"),
                    (f"{prefix}.mlp.2.weight", (d, 4 * d), "linear"),
                    (f"{prefix}.mlp.2.bias", (d,), "bias")])
        ln(prefix + ".mlp_ln")

    for i in range(enc_layers):
        block(f"encoder.blocks.{i}", cross=False)
    ln("encoder.ln_post")
    out.extend([("decoder.token_embedding.weight", (vocab, d), "token"),
                ("decoder.positional_embedding", (448, d), "position")])
    for i in range(dec_layers):
        block(f"decoder.blocks.{i}", cross=True)
    ln("decoder.ln")
    return out


def minilm_shapes(d: int = 384, layers: int = 6, ffn: int = 1536, vocab: int = 30522,
                  positions: int = 512) -> list[tuple[str, tuple[int, ...], str]]:
    """HF BERT names, shapes and init kinds for all-MiniLM-L6-v2."""
    out = [("embeddings.word_embeddings.weight", (vocab, d), "token"),
           ("embeddings.position_embeddings.weight", (positions, d), "position"),
           ("embeddings.token_type_embeddings.weight", (2, d), "position"),
           ("embeddings.LayerNorm.weight", (d,), "ln_weight"),
           ("embeddings.LayerNorm.bias", (d,), "bias")]
    for i in range(layers):
        b = f"encoder.layer.{i}"
        for name, shape in ((f"{b}.attention.self.query", (d, d)),
                            (f"{b}.attention.self.key", (d, d)),
                            (f"{b}.attention.self.value", (d, d)),
                            (f"{b}.attention.output.dense", (d, d)),
                            (f"{b}.intermediate.dense", (ffn, d)),
                            (f"{b}.output.dense", (d, ffn))):
            out.extend([(name + ".weight", shape, "linear"), (name + ".bias", (shape[0],), "bias")])
        for ln in (f"{b}.attention.output.LayerNorm", f"{b}.output.LayerNorm"):
            out.extend([(ln + ".weight", (d,), "ln_weight"), (ln + ".bias", (d,), "bias")])
    return out


def _bound(kind: str, shape: tuple[int, ...], token_std: float) -> tuple[float, float]:
    """(half-width, centre) of the uniform draw of one tensor."""
    if kind == "linear":
        return math.sqrt(6.0 / (shape[0] + shape[1])), 0.0
    if kind == "conv":
        return math.sqrt(6.0 / ((shape[0] + shape[1]) * shape[2])), 0.0
    if kind == "token":
        return token_std * math.sqrt(3.0), 0.0
    if kind == "position":
        return 0.02, 0.0
    if kind == "ln_weight":
        return 0.1, 1.0
    return 0.02, 0.0  # bias


def seeded_state_dict(shapes, seed: int, device, dtype: torch.dtype,
                      token_std: float) -> dict[str, torch.Tensor]:
    """One uniform draw for all tensors, from a generator on `device` seeded
    with `seed`, in `dtype`; each tensor a view of it, scaled in place. The
    same seed, device type and dtype give the same tensors."""
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=dtype)
    flat.mul_(2).sub_(1)
    out, off = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        half, centre = _bound(kind, shape, token_std)
        view = flat[off:off + n].view(shape)
        view.mul_(half).add_(centre)
        out[name] = view
        off += n
    return out


def whisper_weights(dims: dict, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    d = dims["d_model"]
    shapes = whisper_shapes(d, dims["num_mel_bins"], dims["encoder_layers"],
                            dims["decoder_layers"], dims["vocab_size"])
    # logits spread by ~1: the final layer norm's unit-scale output against
    # token rows of std 1 / sqrt(d)
    return seeded_state_dict(shapes, seed, device, dtype, token_std=1.0 / math.sqrt(d))


def minilm_weights(dims: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = minilm_shapes(dims["hidden_size"], dims["num_hidden_layers"],
                           dims["intermediate_size"], dims["vocab_size"],
                           dims["max_position_embeddings"])
    # token rows 100 times the port's 0.05-scaled xavier init (about 0.04)
    return seeded_state_dict(shapes, seed, device, torch.float32, token_std=0.04)
