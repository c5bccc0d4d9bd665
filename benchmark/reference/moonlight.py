"""Moonlight-16B-A3B (`deepseek_v3`) as its checkpoint's `modeling_deepseek.py`
computes it, in plain PyTorch: a full causal forward over whole sequences,
keys and values decompressed, each routed expert in a loop over the tokens
it was given. No kernel, no cache, no batching of sequences; float32 (TF32
off) unless a float8 `Arith` is given (the control).

It runs on the card after the port is released, layer after layer: the
caller hands it each layer's seeded bf16 tensors in turn, and it widens one
layer at a time to float32 (2.3 GB, where the whole model in float32 would
be 64 GB), running every sequence, and every arithmetic asked for, through
that layer before the next.

Routing. A choice of experts is a discontinuous function of the scores.
Two readings keep it apart from the rest of the forward pass:
- the routing itself, teacher-forced (`forced`): given another model's
  router inputs and the experts it chose from them, the reference routes
  the same inputs in float32 and records the widest gap of a chosen
  expert's choice score below its own k-th best (`forced_gap`). Rounding
  of the same inputs moves no choice score past float32's own rounding;
  a fault of the router (a bias at the wrong scale, a gate in bf16, the
  bias left out) does;
- the forward pass around it: the reference's own hidden states drift
  from a bf16 program's through the layers, so where two experts' choice
  scores lie close the two choose differently on their own states, the
  token's expert layer output jumps, and the jump spreads through later
  layers and tokens. So a reference given the program's own choices
  (`follow`) takes them where they are within `ambiguity` of its own k-th
  best choice score on its own states, and its own choice elsewhere; it
  records the widest gap of a followed program's choice below its k-th
  best there (`drift`, over all choices, taken or not) and how many
  differing choices it took.

Departures from the published description:
- RoPE's cos and sin stay float32 (the published code casts them to the
  activations' type, bf16 when served);
- only the variant Moonlight is (no q LoRA, one expert group, no rope
  scaling) is written out.

Parameters use the checkpoint's key names (`model.layers.{i}.mlp.experts.
{e}.gate_proj.weight`, ...). Imports nothing of the program.
"""
from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Arith


def layer_shapes(cfg: dict, part) -> list[tuple[str, tuple[int, ...]]]:
    """The checkpoint's tensors of one part, by key name, with their shapes:
    "embed" (the token embedding), a layer index, or "head" (the final norm
    and `lm_head`)."""
    d, h, lora = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    if part == "embed":
        return [("model.embed_tokens.weight", (cfg["vocab_size"], d))]
    if part == "head":
        return [("model.norm.weight", (d,)), ("lm_head.weight", (cfg["vocab_size"], d))]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    e, m = cfg["n_routed_experts"], cfg["moe_intermediate_size"]

    def mlp(pre: str, width: int) -> list:
        return [(pre + "gate_proj.weight", (width, d)), (pre + "up_proj.weight", (width, d)),
                (pre + "down_proj.weight", (d, width))]
    pre = f"model.layers.{part}."
    out = [(pre + "input_layernorm.weight", (d,)),
           (pre + "self_attn.q_proj.weight", (h * (nope + rope), d)),
           (pre + "self_attn.kv_a_proj_with_mqa.weight", (lora + rope, d)),
           (pre + "self_attn.kv_a_layernorm.weight", (lora,)),
           (pre + "self_attn.kv_b_proj.weight", (h * (nope + vd), lora)),
           (pre + "self_attn.o_proj.weight", (d, h * vd)),
           (pre + "post_attention_layernorm.weight", (d,))]
    if part < cfg["first_k_dense_replace"]:
        return out + mlp(pre + "mlp.", cfg["intermediate_size"])
    out += [(pre + "mlp.gate.weight", (e, d)), (pre + "mlp.gate.e_score_correction_bias", (e,))]
    for j in range(e):
        out += mlp(f"{pre}mlp.experts.{j}.", m)
    return out + mlp(pre + "mlp.shared_experts.", m * cfg["n_shared_experts"])


def parts(cfg: dict) -> list:
    """The checkpoint's parts in the order of the forward pass."""
    return ["embed", *range(cfg["num_hidden_layers"]), "head"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """As published: the pairs read interleaved (x.view(..., r/2, 2) taken
    by columns), then rotated by halves."""
    shape = x.shape
    x = x.reshape(*shape[:-1], shape[-1] // 2, 2).transpose(-1, -2).reshape(shape)
    return x * cos + _rotate_half(x) * sin


class Moonlight:
    """The forward pass in one arithmetic (float32, or float8 for the
    control) over the parameters of one part at a time. `follow(s, i)`
    gives another model's experts [T, k] for sequence s at layer i, taken
    where they lie within `ambiguity` of this model's own choice;
    `forced(s, i)` gives another model's router inputs [T', d] and the
    experts [T', k] it chose from them, routed here again (`forced_gap`).
    The experts this model routed to are kept in `chosen[(s, i)]`, and with
    `keep_inputs` its router inputs in `inputs[(s, i)]`."""

    def __init__(self, cfg: dict, arith: Arith | None = None,
                 follow: Callable[[int, int], torch.Tensor] | None = None,
                 ambiguity: float = 0.0,
                 forced: Callable[[int, int], tuple[torch.Tensor, torch.Tensor]] | None = None,
                 keep_inputs: bool = False):
        self.cfg = cfg
        self.a = arith or Arith()
        self.follow, self.ambiguity, self.forced = follow, ambiguity, forced
        self.keep_inputs = keep_inputs
        self.chosen: dict[tuple[int, int], torch.Tensor] = {}
        self.inputs: dict[tuple[int, int], torch.Tensor] = {}
        self.drift = 0.0       # the widest gap of a followed choice below the k-th best
        self.followed = 0      # token-layers where a differing followed choice was taken
        self.forced_gap = 0.0  # the widest gap of a forced choice below the k-th best
        self.forced_tokens = 0  # token-layers routed again

    def _lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.a.linear(x, w)

    def rope_tables(self, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        r = self.cfg["qk_rope_head_dim"]
        inv = 1.0 / (self.cfg["rope_theta"] ** (torch.arange(0, r, 2, device=device).float() / r))
        emb = torch.outer(torch.arange(n, device=device).float(), inv)
        emb = torch.cat([emb, emb], -1)
        return emb.cos(), emb.sin()

    def attention(self, x: torch.Tensor, p: dict, pre: str) -> torch.Tensor:
        """Causal MLA over one sequence x [T, d]."""
        c = self.cfg
        t, h = x.shape[0], c["num_attention_heads"]
        nope, rope, vd, lora = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                                c["kv_lora_rank"])
        cos, sin = self.rope_tables(t, x.device)
        q = self._lin(x, p[pre + "self_attn.q_proj.weight"]).view(t, h, nope + rope).transpose(0, 1)
        q_nope, q_pe = q.split([nope, rope], -1)
        c_kv, k_pe = self._lin(x, p[pre + "self_attn.kv_a_proj_with_mqa.weight"]).split(
            [lora, rope], -1)
        c_kv = rms_norm(c_kv, p[pre + "self_attn.kv_a_layernorm.weight"], c["rms_norm_eps"])
        kv = self._lin(c_kv, p[pre + "self_attn.kv_b_proj.weight"]).view(t, h, nope + vd)
        k_nope, v = kv.transpose(0, 1).split([nope, vd], -1)
        q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe[None], cos, sin)
        q = torch.cat([q_nope, q_pe], -1)
        k = torch.cat([k_nope, k_pe.expand(h, t, rope)], -1)
        s = self.a.matmul(q, k.transpose(1, 2)) * (nope + rope) ** -0.5
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
        o = self.a.matmul(s.softmax(-1), v).transpose(0, 1).reshape(t, h * vd)
        return self._lin(o, p[pre + "self_attn.o_proj.weight"])

    def mlp(self, x: torch.Tensor, p: dict, pre: str) -> torch.Tensor:
        g = self._lin(x, p[pre + "gate_proj.weight"])
        u = self._lin(x, p[pre + "up_proj.weight"])
        return self._lin(F.silu(g) * u, p[pre + "down_proj.weight"])

    def choice(self, x: torch.Tensor, p: dict, pre: str):
        """(sigmoid scores, choice scores: scores plus the correction bias)
        [T, E] of router inputs x [T, d]."""
        scores = self._lin(x, p[pre + "mlp.gate.weight"]).sigmoid()
        return scores, scores + p[pre + "mlp.gate.e_score_correction_bias"]

    def gap(self, choice: torch.Tensor, kth: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
        """Per token, the widest gap of the given experts [T, k] below the
        k-th best choice score kth [T, 1] (0 where each is among the best)."""
        return (kth - choice.gather(1, experts.to(choice.device).long())).clamp_min(0).amax(-1)

    def route_forced(self, x: torch.Tensor, experts: torch.Tensor, p: dict, pre: str) -> None:
        """Route another model's router inputs x [T', d] in this model's
        arithmetic and record how far below the k-th best its experts
        [T', k] chosen from them lie."""
        _, choice = self.choice(x.to(p[pre + "mlp.gate.weight"].device), p, pre)
        kth = choice.topk(self.cfg["num_experts_per_tok"], -1).values[:, -1:]
        if len(x):
            self.forced_gap = max(self.forced_gap, float(self.gap(choice, kth, experts).max()))
        self.forced_tokens += len(x)

    def route(self, x: torch.Tensor, p: dict, pre: str, other: torch.Tensor | None = None):
        """(weights [T, k], experts [T, k]) as `MoEGate` with `noaux_tc`;
        with `other`, another model's experts, taken where each of them
        scores within `ambiguity` of the k-th best choice."""
        c = self.cfg
        scores, choice = self.choice(x, p, pre)
        top = choice.topk(c["num_experts_per_tok"], -1)
        experts = top.indices
        if other is not None:
            other = other.to(x.device).long()
            gap = self.gap(choice, top.values[:, -1:], other)
            take = gap <= self.ambiguity
            differs = (other.sort(-1).values != experts.sort(-1).values).any(-1)
            self.drift = max(self.drift, float(gap.max()))
            self.followed += int((take & differs).sum())
            experts = torch.where(take[:, None], other, experts)
        w = scores.gather(1, experts)
        if c["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * c["routed_scaling_factor"], experts

    def moe(self, x: torch.Tensor, p: dict, pre: str, s: int, i: int) -> torch.Tensor:
        if self.forced:
            self.route_forced(*self.forced(s, i), p, pre)
        w, experts = self.route(x, p, pre, self.follow(s, i) if self.follow else None)
        self.chosen[(s, i)] = experts
        if self.keep_inputs:
            self.inputs[(s, i)] = x
        out = torch.zeros_like(x)
        for e in range(self.cfg["n_routed_experts"]):
            tok, slot = (experts == e).nonzero(as_tuple=True)
            if len(tok):
                y = self.mlp(x[tok], p, f"{pre}mlp.experts.{e}.")
                out.index_add_(0, tok, w[tok, slot, None] * y)
        return out + self.mlp(x, p, pre + "mlp.shared_experts.")

    def layer(self, x: torch.Tensor, p: dict, i: int, s: int = 0) -> torch.Tensor:
        """Layer i of sequence s."""
        pre, eps = f"model.layers.{i}.", self.cfg["rms_norm_eps"]
        x = x + self.attention(rms_norm(x, p[pre + "input_layernorm.weight"], eps), p, pre)
        h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], eps)
        return x + (self.mlp(h, p, pre + "mlp.") if i < self.cfg["first_k_dense_replace"]
                    else self.moe(h, p, pre, s, i))

    def head(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        x = rms_norm(x, p["model.norm.weight"], self.cfg["rms_norm_eps"])
        return self._lin(x, p["lm_head.weight"])


@torch.no_grad()
def logits(cfg: dict, weights: Callable[[object], dict], seqs: list[list[int]],
           positions: list[list[int]], models: list[Moonlight], device
           ) -> list[list[torch.Tensor]]:
    """For each model, each sequence's logits [len(positions[s]), V] at its
    positions, each position seeing itself and those before it. The models
    run layer by layer in the order given (one that follows another's
    choices comes after it). `weights(part)` gives a part's tensors (any
    type; widened here to float32 one part at a time)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        xs: list[list[torch.Tensor]] = []
        out: list[list[torch.Tensor]] = []
        for part in parts(cfg):
            p = {k: v.to(device).float() for k, v in weights(part).items()}
            if part == "embed":
                table = p["model.embed_tokens.weight"]
                xs = [[table[torch.tensor(s, device=device)] for s in seqs] for _ in models]
            elif part == "head":
                out = [[m.head(x[torch.tensor(pos, device=device)], p)
                        for x, pos in zip(xs_m, positions)] for m, xs_m in zip(models, xs)]
            else:
                xs = [[m.layer(x, p, part, s) for s, x in enumerate(xs_m)]
                      for m, xs_m in zip(models, xs)]
            del p
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
