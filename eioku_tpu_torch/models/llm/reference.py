"""Moonlight-16B-A3B (`deepseek_v3`) as its checkpoint's `modeling_deepseek.py`
computes it, in plain float32 torch: one sequence at a time, a full causal
forward over all its positions, keys and values decompressed, each routed
expert in a loop over the tokens it was given. No kernel, no cache, no
batching; the parameters under the checkpoint's own key names. Imports
nothing else of the port: the tests hold `models/llm/model.py` to it.

Departures from the published description:
- everything is float32, RoPE's cos and sin included (the published code
  casts them to the activations' type, bf16 when served);
- only the variant Moonlight is (no q LoRA, one expert group, no rope
  scaling) is written out.
"""
from __future__ import annotations

import torch


def checkpoint_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """The checkpoint's tensors, by their key names, and their shapes."""
    d, h, lora = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    e, m = cfg["n_routed_experts"], cfg["moe_intermediate_size"]

    def mlp(pre: str, width: int) -> list:
        return [(pre + "gate_proj.weight", (width, d)), (pre + "up_proj.weight", (width, d)),
                (pre + "down_proj.weight", (d, width))]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], d))]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        out += [(pre + "input_layernorm.weight", (d,)),
                (pre + "self_attn.q_proj.weight", (h * (nope + rope), d)),
                (pre + "self_attn.kv_a_proj_with_mqa.weight", (lora + rope, d)),
                (pre + "self_attn.kv_a_layernorm.weight", (lora,)),
                (pre + "self_attn.kv_b_proj.weight", (h * (nope + vd), lora)),
                (pre + "self_attn.o_proj.weight", (d, h * vd)),
                (pre + "post_attention_layernorm.weight", (d,))]
        if i < cfg["first_k_dense_replace"]:
            out += mlp(pre + "mlp.", cfg["intermediate_size"])
            continue
        out += [(pre + "mlp.gate.weight", (e, d)), (pre + "mlp.gate.e_score_correction_bias", (e,))]
        for j in range(e):
            out += mlp(f"{pre}mlp.experts.{j}.", m)
        out += mlp(pre + "mlp.shared_experts.", m * cfg["n_shared_experts"])
    return out + [("model.norm.weight", (d,)), ("lm_head.weight", (cfg["vocab_size"], d))]


def _w(state: dict, name: str) -> torch.Tensor:
    return state[name].float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_tables(cfg: dict, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [n, r] of positions 0 .. n - 1, the frequencies repeated."""
    r = cfg["qk_rope_head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, r, 2).float() / r))
    emb = torch.outer(torch.arange(n).float(), inv)
    emb = torch.cat([emb, emb], -1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """As published: the pairs read interleaved (x.view(..., r/2, 2) taken
    by columns), then rotated by halves."""
    shape = x.shape
    x = x.reshape(*shape[:-1], shape[-1] // 2, 2).transpose(-1, -2).reshape(shape)
    return x * cos + _rotate_half(x) * sin


def attention(x: torch.Tensor, state: dict, pre: str, cfg: dict, cos, sin) -> torch.Tensor:
    """Causal MLA over one sequence x [T, d]."""
    t, h = x.shape[0], cfg["num_attention_heads"]
    nope, rope, vd, lora = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                            cfg["kv_lora_rank"])
    q = (x @ _w(state, pre + "self_attn.q_proj.weight").T).view(t, h, nope + rope).transpose(0, 1)
    q_nope, q_pe = q.split([nope, rope], -1)
    kv_a = x @ _w(state, pre + "self_attn.kv_a_proj_with_mqa.weight").T
    c_kv, k_pe = kv_a.split([lora, rope], -1)
    c_kv = rms_norm(c_kv, _w(state, pre + "self_attn.kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = (c_kv @ _w(state, pre + "self_attn.kv_b_proj.weight").T).view(t, h, nope + vd)
    k_nope, v = kv.transpose(0, 1).split([nope, vd], -1)
    q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe[None], cos, sin)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(h, t, rope)], -1)
    s = q @ k.transpose(1, 2) * (nope + rope) ** -0.5
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    o = (s.softmax(-1) @ v).transpose(0, 1).reshape(t, h * vd)
    return o @ _w(state, pre + "self_attn.o_proj.weight").T


def mlp(x: torch.Tensor, state: dict, pre: str) -> torch.Tensor:
    g = x @ _w(state, pre + "gate_proj.weight").T
    u = x @ _w(state, pre + "up_proj.weight").T
    return (torch.nn.functional.silu(g) * u) @ _w(state, pre + "down_proj.weight").T


def route(x: torch.Tensor, state: dict, pre: str, cfg: dict):
    """(weights [T, k], experts [T, k]) as `MoEGate` with `noaux_tc`."""
    scores = (x @ _w(state, pre + "mlp.gate.weight").T).sigmoid()
    choice = scores + _w(state, pre + "mlp.gate.e_score_correction_bias")
    experts = choice.topk(cfg["num_experts_per_tok"], -1).indices
    w = scores.gather(1, experts)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg["routed_scaling_factor"], experts


def moe(x: torch.Tensor, state: dict, pre: str, cfg: dict) -> torch.Tensor:
    w, experts = route(x, state, pre, cfg)
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if len(tok):
            y = mlp(x[tok], state, f"{pre}mlp.experts.{e}.")
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out + mlp(x, state, pre + "mlp.shared_experts.")


def layer(x: torch.Tensor, state: dict, i: int, cfg: dict, cos, sin) -> torch.Tensor:
    pre, eps = f"model.layers.{i}.", cfg["rms_norm_eps"]
    x = x + attention(rms_norm(x, _w(state, pre + "input_layernorm.weight"), eps), state, pre,
                      cfg, cos, sin)
    h = rms_norm(x, _w(state, pre + "post_attention_layernorm.weight"), eps)
    return x + (mlp(h, state, pre + "mlp.") if i < cfg["first_k_dense_replace"]
                else moe(h, state, pre, cfg))


def forward(state: dict, cfg: dict, ids: list[int], positions: list[int] | None = None
            ) -> torch.Tensor:
    """The logits [len(positions), V] (every position by default) of one
    sequence of ids, each position seeing itself and those before it."""
    cos, sin = rope_tables(cfg, len(ids))
    x = _w(state, "model.embed_tokens.weight")[torch.tensor(ids)]
    for i in range(cfg["num_hidden_layers"]):
        x = layer(x, state, i, cfg, cos, sin)
    if positions is not None:
        x = x[torch.tensor(positions)]
    x = rms_norm(x, _w(state, "model.norm.weight"), cfg["rms_norm_eps"])
    return x @ _w(state, "lm_head.weight").T
