"""Kimi-Linear-48B-A3B (`kimi_linear`) in plain float32 torch: one sequence at
a time, no cache, no batching. KDA is the token-by-token recurrence of the
Kimi Linear report (arXiv:2510.26692) and flash-linear-attention's
`fla/layers/kda.py`; MLA has no RoPE (`mla_use_nope`) and attends with keys
and values decompressed over the whole causal sequence; each routed expert
runs in a loop over the tokens it was given. Parameters under the key names
of `checkpoint_shapes`. Imports nothing else of the port: the tests hold
`models/llm/kimi_linear.py` to it.

The layer (`linear_attn_config`: 1-based MLA and KDA layers): x + mixing(
RMSNorm(x)), then x + MLP or MoE (RMSNorm(x)). KDA per head, token t:
  q, k, v = SiLU(causal depthwise conv(W_q x, W_k x, W_v x)), q and k
  L2-normalised, q scaled by d_k^-1/2; g = -exp(A_log) softplus(W_f_b W_f_a
  x + dt_bias); beta = sigmoid(W_b x);
  S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T;
  o_t = S_t^T q_t; out = W_o [RMSNorm_head(o_t) * sigmoid(W_g_b W_g_a x)].

Departures from the published description:
- everything is float32; the published KDA kernels take bf16 inputs;
- the L2 norm is x / sqrt(sum x^2 + 1e-6), as fla's `l2norm`;
- the expert layer may compute a share of the experts (`num_experts` of
  `num_router_experts` from `first_held_expert`, expert parallelism's
  share of one card): routing is over all of them, and the absent experts'
  part is left out;
- key names not checked against the published modeling file: MLA, norms
  and experts under DeepSeek-V3's (as Moonlight's), KDA's under fla's
  `KimiDeltaAttention` (q/k/v_proj, q/k/v_conv1d, f_a/f_b_proj, b_proj,
  g_a/g_b_proj, A_log [H], dt_bias, o_norm, o_proj); no bias on g_b_proj.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def kinds(cfg: dict) -> list[str]:
    full = set(cfg["linear_attn_config"]["full_attn_layers"])
    return ["mla" if i + 1 in full else "kda" for i in range(cfg["num_hidden_layers"])]


def held_experts(cfg: dict) -> range:
    first = cfg.get("first_held_expert", 0)
    return range(first, first + cfg["num_experts"])


def router_experts(cfg: dict) -> int:
    return cfg.get("num_router_experts") or cfg["num_experts"]


def checkpoint_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """The checkpoint's tensors (the held experts' only), by their key names,
    and their shapes."""
    d, h, lora = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    la = cfg["linear_attn_config"]
    hk, r, taps = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    w, m = hk * r, cfg["moe_intermediate_size"]

    def mlp(pre: str, width: int) -> list:
        return [(pre + "gate_proj.weight", (width, d)), (pre + "up_proj.weight", (width, d)),
                (pre + "down_proj.weight", (d, width))]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], d))]
    for i, kind in enumerate(kinds(cfg)):
        pre = f"model.layers.{i}."
        a = pre + "self_attn."
        out += [(pre + "input_layernorm.weight", (d,)),
                (pre + "post_attention_layernorm.weight", (d,))]
        if kind == "mla":
            out += [(a + "q_proj.weight", (h * (nope + rope), d)),
                    (a + "kv_a_proj_with_mqa.weight", (lora + rope, d)),
                    (a + "kv_a_layernorm.weight", (lora,)),
                    (a + "kv_b_proj.weight", (h * (nope + vd), lora)),
                    (a + "o_proj.weight", (d, h * vd))]
        else:
            out += [(a + f"{p}_proj.weight", (w, d)) for p in "qkv"]
            out += [(a + f"{p}_conv1d.weight", (w, 1, taps)) for p in "qkv"]
            out += [(a + "f_a_proj.weight", (r, d)), (a + "f_b_proj.weight", (w, r)),
                    (a + "b_proj.weight", (hk, d)), (a + "A_log", (hk,)), (a + "dt_bias", (w,)),
                    (a + "g_a_proj.weight", (r, d)), (a + "g_b_proj.weight", (w, r)),
                    (a + "o_norm.weight", (r,)), (a + "o_proj.weight", (d, w))]
        if i < cfg["first_k_dense_replace"]:
            out += mlp(pre + "mlp.", cfg["intermediate_size"])
            continue
        e = router_experts(cfg)
        out += [(pre + "mlp.gate.weight", (e, d)), (pre + "mlp.gate.e_score_correction_bias", (e,))]
        for j in held_experts(cfg):
            out += mlp(f"{pre}mlp.experts.{j}.", m)
        out += mlp(pre + "mlp.shared_experts.", m * cfg["num_shared_experts"])
    return out + [("model.norm.weight", (d,)), ("lm_head.weight", (cfg["vocab_size"], d))]


def _w(state: dict, name: str) -> torch.Tensor:
    return state[name].float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def mla(x: torch.Tensor, state: dict, pre: str, cfg: dict) -> torch.Tensor:
    """Causal MLA without RoPE over one sequence x [T, d]."""
    t, h = x.shape[0], cfg["num_attention_heads"]
    nope, rope, vd, lora = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                            cfg["kv_lora_rank"])
    q = (x @ _w(state, pre + "q_proj.weight").T).view(t, h, nope + rope).transpose(0, 1)
    c_kv, k_pe = (x @ _w(state, pre + "kv_a_proj_with_mqa.weight").T).split([lora, rope], -1)
    c_kv = rms_norm(c_kv, _w(state, pre + "kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = (c_kv @ _w(state, pre + "kv_b_proj.weight").T).view(t, h, nope + vd)
    k_nope, v = kv.transpose(0, 1).split([nope, vd], -1)
    k = torch.cat([k_nope, k_pe[None].expand(h, t, rope)], -1)
    s = q @ k.transpose(1, 2) * (nope + rope) ** -0.5
    s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    o = (s.softmax(-1) @ v).transpose(0, 1).reshape(t, h * vd)
    return o @ _w(state, pre + "o_proj.weight").T


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of x [T, C] with taps w [C, 1, K], then SiLU:
    y_t = sum_j w[j] x_{t-K+1+j}, zeros before the sequence."""
    taps = w.shape[-1]
    xp = torch.cat([x.new_zeros(taps - 1, x.shape[1]), x])
    y = sum(w[:, 0, j] * xp[j:j + x.shape[0]] for j in range(taps))
    return F.silu(y)


def recurrence(q, k, v, g, beta, S: torch.Tensor):
    """The delta rule token by token: q, k, v, g [T, H, d], beta [T, H], the
    state S [H, d_k, d_v] -> (o [T, H, d_v], the last state)."""
    o = []
    for i in range(k.shape[0]):
        S = S * g[i].exp()[:, :, None]
        u = beta[i][:, None] * (v[i] - torch.einsum("hk,hkv->hv", k[i], S))
        S = S + k[i][:, :, None] * u[:, None, :]
        o.append(torch.einsum("hk,hkv->hv", q[i], S))
    return torch.stack(o), S


def kda(x: torch.Tensor, state: dict, pre: str, cfg: dict) -> torch.Tensor:
    """KDA over one sequence x [T, d], the recurrence token by token from a
    zero state."""
    t = x.shape[0]
    la = cfg["linear_attn_config"]
    h, r = la["num_heads"], la["head_dim"]
    q, k, v = (short_conv(x @ _w(state, pre + f"{p}_proj.weight").T,
                          _w(state, pre + f"{p}_conv1d.weight")).view(t, h, r) for p in "qkv")
    q, k = l2_norm(q) * r ** -0.5, l2_norm(k)
    f = (x @ _w(state, pre + "f_a_proj.weight").T) @ _w(state, pre + "f_b_proj.weight").T
    g = -_w(state, pre + "A_log").exp()[:, None] * F.softplus(
        (f + _w(state, pre + "dt_bias")).view(t, h, r))
    beta = (x @ _w(state, pre + "b_proj.weight").T).sigmoid()
    o, _ = recurrence(q, k, v, g, beta, x.new_zeros(h, r, r))
    o = rms_norm(o, _w(state, pre + "o_norm.weight"), cfg["rms_norm_eps"])
    gate = ((x @ _w(state, pre + "g_a_proj.weight").T) @ _w(state, pre + "g_b_proj.weight").T)
    o = o * gate.view(t, h, r).sigmoid()
    return o.reshape(t, h * r) @ _w(state, pre + "o_proj.weight").T


def mlp(x: torch.Tensor, state: dict, pre: str) -> torch.Tensor:
    g = x @ _w(state, pre + "gate_proj.weight").T
    u = x @ _w(state, pre + "up_proj.weight").T
    return (F.silu(g) * u) @ _w(state, pre + "down_proj.weight").T


def route(x: torch.Tensor, state: dict, pre: str, cfg: dict):
    """(weights [T, k], experts [T, k]): sigmoid scores over the router's
    experts, the top k on score plus the correction bias, weighted by the
    scores, renormalised and scaled."""
    scores = (x @ _w(state, pre + "mlp.gate.weight").T).sigmoid()
    choice = scores + _w(state, pre + "mlp.gate.e_score_correction_bias")
    experts = choice.topk(cfg["num_experts_per_token"], -1).indices
    w = scores.gather(1, experts)
    if cfg["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg["routed_scaling_factor"], experts


def routed(x: torch.Tensor, state: dict, pre: str, cfg: dict, held: range) -> torch.Tensor:
    """The part of the routed experts in `held` (global ids) of the layer's
    output."""
    w, experts = route(x, state, pre, cfg)
    out = torch.zeros_like(x)
    for e in held:
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if len(tok):
            y = mlp(x[tok], state, f"{pre}mlp.experts.{e}.")
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out


def layer(x: torch.Tensor, state: dict, i: int, cfg: dict) -> torch.Tensor:
    pre, eps = f"model.layers.{i}.", cfg["rms_norm_eps"]
    mix = mla if kinds(cfg)[i] == "mla" else kda
    x = x + mix(rms_norm(x, _w(state, pre + "input_layernorm.weight"), eps), state,
                pre + "self_attn.", cfg)
    h = rms_norm(x, _w(state, pre + "post_attention_layernorm.weight"), eps)
    if i < cfg["first_k_dense_replace"]:
        return x + mlp(h, state, pre + "mlp.")
    return x + routed(h, state, pre, cfg, held_experts(cfg)) + \
        mlp(h, state, pre + "mlp.shared_experts.")


def forward(state: dict, cfg: dict, ids: list[int], positions: list[int] | None = None
            ) -> torch.Tensor:
    """The logits [len(positions), V] (every position by default) of one
    sequence of ids, each position seeing itself and those before it."""
    x = _w(state, "model.embed_tokens.weight")[torch.tensor(ids)]
    for i in range(cfg["num_hidden_layers"]):
        x = layer(x, state, i, cfg)
    if positions is not None:
        x = x[torch.tensor(positions)]
    x = rms_norm(x, _w(state, "model.norm.weight"), cfg["rms_norm_eps"])
    return x @ _w(state, "lm_head.weight").T
