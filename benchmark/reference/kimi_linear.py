"""Kimi-Linear-48B-A3B (`kimi_linear`) in plain PyTorch: a full causal
forward over whole sequences, no cache, no batching of sequences; float32
(TF32 off) unless a float8 `Arith` is given (the control). The benchmark's
copy of the plain reference (the port's is
`eioku_tpu_torch/models/llm/kimi_linear_reference.py`); it imports nothing
of the program.

The layer: pre-norm token mixing, then a dense MLP (layer 0) or the expert
layer; token mixing by the schedule of `linear_attn_config` (1-based):
- MLA without RoPE (`mla_use_nope`): keys and values decompressed through
  kv_b_proj, the rope parts of the queries and the shared key unrotated,
  causal softmax attention over the whole sequence, in blocks of QBLOCK
  queries so that the scores of a 42k-token sequence fit;
- KDA (arXiv:2510.26692, `fla/layers/kda.py`): q, k, v through a causal
  depthwise conv of 4 and SiLU, q and k L2-normalised (q scaled by
  d^-1/2), the log decay g = -exp(A_log) softplus(W_f_b W_f_a x + dt_bias),
  beta = sigmoid(W_b x), then
    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T,
    o_t = S_t^T q_t,
  and W_o [RMSNorm_head(o) * sigmoid(W_g_b W_g_a x)]. `recurrence` runs it
  token by token; `blocks` runs the same recurrence over blocks of 64
  tokens (the decay between every pair of a block's tokens taken exactly,
  the block's delta-rule updates solved as one triangular system), which
  is what the check runs on a 42k-token sequence; a CPU test holds the two
  equal.
- the expert layer: sigmoid scores over the router's experts plus the
  correction bias choose the top k, weighted by the scores, renormalised
  and scaled; the share of experts this card holds (`num_experts` from
  `first_held_expert`) computes its part, the absent experts' part is left
  out, as the program does; the shared expert always.

It runs layer by layer through `reference.moonlight.logits` (the same
routing readings: `follow`, `forced`, `drift`, `forced_gap`), widening one
layer's seeded bf16 tensors at a time to float32.

Departures from the published description: everything float32; the L2 norm
is x / sqrt(sum x^2 + 1e-6), as fla's `l2norm`; the key names (DeepSeek-V3's
for MLA, norms and experts; fla's KimiDeltaAttention's for KDA, A_log [H],
no bias on g_b_proj) are assumed, not checked against the published
modeling file.
"""
from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from benchmark.reference import moonlight as ref_moonlight
from benchmark.reference.moonlight import rms_norm
from benchmark.reference.precision import Arith

BLOCK = 64
QBLOCK = 256


def kinds(cfg: dict) -> list[str]:
    full = set(cfg["linear_attn_config"]["full_attn_layers"])
    return ["mla" if i + 1 in full else "kda" for i in range(cfg["num_hidden_layers"])]


def held_experts(cfg: dict) -> range:
    first = cfg.get("first_held_expert", 0)
    return range(first, first + cfg["num_experts"])


def layer_shapes(cfg: dict, part) -> list[tuple[str, tuple[int, ...]]]:
    """The checkpoint's tensors of one part (the held experts' only), by key
    name, with their shapes: "embed", a layer index, or "head"."""
    d, h, lora = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    if part == "embed":
        return [("model.embed_tokens.weight", (cfg["vocab_size"], d))]
    if part == "head":
        return [("model.norm.weight", (d,)), ("lm_head.weight", (cfg["vocab_size"], d))]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    la = cfg["linear_attn_config"]
    hk, r, taps = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    w, m = hk * r, cfg["moe_intermediate_size"]

    def mlp(pre: str, width: int) -> list:
        return [(pre + "gate_proj.weight", (width, d)), (pre + "up_proj.weight", (width, d)),
                (pre + "down_proj.weight", (d, width))]
    pre = f"model.layers.{part}."
    a = pre + "self_attn."
    out = [(pre + "input_layernorm.weight", (d,)),
           (pre + "post_attention_layernorm.weight", (d,))]
    if kinds(cfg)[part] == "mla":
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
    if part < cfg["first_k_dense_replace"]:
        return out + mlp(pre + "mlp.", cfg["intermediate_size"])
    e = cfg.get("num_router_experts") or cfg["num_experts"]
    out += [(pre + "mlp.gate.weight", (e, d)), (pre + "mlp.gate.e_score_correction_bias", (e,))]
    for j in held_experts(cfg):
        out += mlp(f"{pre}mlp.experts.{j}.", m)
    return out + mlp(pre + "mlp.shared_experts.", m * cfg["num_shared_experts"])


def parts(cfg: dict) -> list:
    return ref_moonlight.parts(cfg)


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def recurrence(q, k, v, g, beta, S: torch.Tensor):
    """The delta rule token by token: q, k, v, g [T, H, d], beta [T, H], S
    [H, d_k, d_v] -> (o [T, H, d_v], the last state)."""
    o = []
    for i in range(k.shape[0]):
        S = S * g[i].exp()[:, :, None]
        u = beta[i][:, None] * (v[i] - torch.einsum("hk,hkv->hv", k[i], S))
        S = S + k[i][:, :, None] * u[:, None, :]
        o.append(torch.einsum("hk,hkv->hv", q[i], S))
    return torch.stack(o), S


def blocks(q, k, v, g, beta, S: torch.Tensor, block: int = BLOCK):
    """The same recurrence over blocks of `block` tokens. Within a block of
    c tokens from state S, with G the cumulative log decay and D_ts = exp(G_t
    - G_s) (s <= t) for every pair: the updates u solve the unit lower
    triangular system (I + beta_t k_t.(D_ts k_s) for s < t) u = beta (v - (k
    e^G) S); o_t = (q_t e^G_t) S + sum_{s<=t} q_t.(D_ts k_s) u_s; the block
    ends in e^{G_c} S + sum_s (k_s e^{G_c - G_s}) u_s^T."""
    out = []
    for s0 in range(0, k.shape[0], block):
        qb, kb, vb, gb = (x[s0:s0 + block].transpose(0, 1) for x in (q, k, v, g))
        bb = beta[s0:s0 + block].T
        c = kb.shape[1]
        G = gb.cumsum(1)
        causal = torch.ones(c, c, dtype=torch.bool, device=k.device).tril()
        D = (G[:, :, None, :] - G[:, None, :, :]).masked_fill(~causal[..., None],
                                                              float("-inf")).exp()
        kk = torch.einsum("htc,hsc,htsc->hts", kb, kb, D)
        qk = torch.einsum("htc,hsc,htsc->hts", qb, kb, D)
        system = torch.eye(c, device=k.device) + bb[..., None] * kk.tril(-1)
        u = torch.linalg.solve_triangular(system, bb[..., None] * (vb - (kb * G.exp()) @ S),
                                          upper=False)
        out.append((qb * G.exp()) @ S + qk @ u)
        S = G[:, -1, :, None].exp() * S + (kb * (G[:, -1:] - G).exp()).transpose(1, 2) @ u
    return torch.cat(out, 1).transpose(0, 1), S


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of x [T, C] with taps w [C, 1, K], then SiLU."""
    taps = w.shape[-1]
    xp = torch.cat([x.new_zeros(taps - 1, x.shape[1]), x])
    return F.silu(sum(w[:, 0, j] * xp[j:j + x.shape[0]] for j in range(taps)))


class KimiLinear(ref_moonlight.Moonlight):
    """The forward pass in one arithmetic over the parameters of one part at
    a time, with Moonlight's routing readings (`follow`, `ambiguity`,
    `forced`, `keep_inputs`: `reference.moonlight.Moonlight`). `kda` is
    "blocks" or "tokens" (`recurrence`)."""

    def __init__(self, cfg: dict, arith: Arith | None = None,
                 follow: Callable[[int, int], torch.Tensor] | None = None,
                 ambiguity: float = 0.0,
                 forced: Callable[[int, int], tuple[torch.Tensor, torch.Tensor]] | None = None,
                 keep_inputs: bool = False, kda: str = "blocks"):
        super().__init__({**cfg, "num_experts_per_tok": cfg["num_experts_per_token"],
                          "norm_topk_prob": cfg["moe_renormalize"]},
                         arith, follow, ambiguity, forced, keep_inputs)
        self.kinds = kinds(cfg)
        self.held = held_experts(cfg)
        self.kda_form = kda

    def attention(self, x: torch.Tensor, p: dict, pre: str) -> torch.Tensor:
        """Causal MLA without RoPE over one sequence x [T, d]."""
        c = self.cfg
        t, h = x.shape[0], c["num_attention_heads"]
        nope, rope, vd, lora = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                                c["kv_lora_rank"])
        a = pre + "self_attn."
        q = self._lin(x, p[a + "q_proj.weight"]).view(t, h, nope + rope).transpose(0, 1)
        c_kv, k_pe = self._lin(x, p[a + "kv_a_proj_with_mqa.weight"]).split([lora, rope], -1)
        c_kv = rms_norm(c_kv, p[a + "kv_a_layernorm.weight"], c["rms_norm_eps"])
        kv = self._lin(c_kv, p[a + "kv_b_proj.weight"]).view(t, h, nope + vd)
        k_nope, v = kv.transpose(0, 1).split([nope, vd], -1)
        k = torch.cat([k_nope, k_pe[None].expand(h, t, rope)], -1)
        o = x.new_empty(h, t, vd)
        cols = torch.arange(t, device=x.device)
        for s0 in range(0, t, QBLOCK):
            e = min(s0 + QBLOCK, t)
            s = self.a.matmul(q[:, s0:e], k[:, :e].transpose(1, 2)) * (nope + rope) ** -0.5
            s = s.masked_fill(cols[s0:e, None] < cols[None, :e], float("-inf"))
            o[:, s0:e] = self.a.matmul(s.softmax(-1), v[:, :e])
        return self._lin(o.transpose(0, 1).reshape(t, h * vd), p[a + "o_proj.weight"])

    def kda(self, x: torch.Tensor, p: dict, pre: str) -> torch.Tensor:
        """KDA over one sequence x [T, d] from a zero state."""
        t = x.shape[0]
        la = self.cfg["linear_attn_config"]
        h, r = la["num_heads"], la["head_dim"]
        a = pre + "self_attn."
        q, k, v = (short_conv(self._lin(x, p[a + f"{n}_proj.weight"]),
                              p[a + f"{n}_conv1d.weight"]).view(t, h, r) for n in "qkv")
        q, k = l2_norm(q) * r ** -0.5, l2_norm(k)
        f = self._lin(self._lin(x, p[a + "f_a_proj.weight"]), p[a + "f_b_proj.weight"])
        g = -p[a + "A_log"].reshape(h).exp()[:, None] * F.softplus(
            (f + p[a + "dt_bias"]).view(t, h, r))
        beta = self._lin(x, p[a + "b_proj.weight"]).sigmoid()
        run = blocks if self.kda_form == "blocks" else recurrence
        o, _ = run(q, k, v, g, beta, x.new_zeros(h, r, r))
        o = rms_norm(o, p[a + "o_norm.weight"], self.cfg["rms_norm_eps"])
        gate = self._lin(self._lin(x, p[a + "g_a_proj.weight"]), p[a + "g_b_proj.weight"])
        o = o * gate.view(t, h, r).sigmoid()
        return self._lin(o.reshape(t, h * r), p[a + "o_proj.weight"])

    def moe(self, x: torch.Tensor, p: dict, pre: str, s: int, i: int) -> torch.Tensor:
        """The held experts' part and the shared expert."""
        if self.forced:
            self.route_forced(*self.forced(s, i), p, pre)
        w, experts = self.route(x, p, pre, self.follow(s, i) if self.follow else None)
        self.chosen[(s, i)] = experts
        if self.keep_inputs:
            self.inputs[(s, i)] = x
        out = torch.zeros_like(x)
        for e in self.held:
            tok, slot = (experts == e).nonzero(as_tuple=True)
            if len(tok):
                y = self.mlp(x[tok], p, f"{pre}mlp.experts.{e}.")
                out.index_add_(0, tok, w[tok, slot, None] * y)
        return out + self.mlp(x, p, pre + "mlp.shared_experts.")

    def layer(self, x: torch.Tensor, p: dict, i: int, s: int = 0) -> torch.Tensor:
        pre, eps = f"model.layers.{i}.", self.cfg["rms_norm_eps"]
        mix = self.attention if self.kinds[i] == "mla" else self.kda
        x = x + mix(rms_norm(x, p[pre + "input_layernorm.weight"], eps), p, pre)
        h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], eps)
        return x + (self.mlp(h, p, pre + "mlp.") if i < self.cfg["first_k_dense_replace"]
                    else self.moe(h, p, pre, s, i))


def logits(cfg: dict, weights: Callable[[object], dict], seqs: list[list[int]],
           positions: list[list[int]], models: list[KimiLinear], device
           ) -> list[list[torch.Tensor]]:
    """`reference.moonlight.logits` over these models: each model's logits
    at each sequence's positions, layer by layer, TF32 off."""
    return ref_moonlight.logits(cfg, weights, seqs, positions, models, device)
