"""Kimi-Linear-48B-A3B (huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct,
its `config.json`: `model_type` kimi_linear) for prefill and greedy decode. No
counterpart in the JAX package.

27 layers at width 2,304, in a 3:1 schedule (`linear_attn_config`, 1-based):
Kimi Delta Attention (KDA) at 20 layers, latent attention (MLA) at 4, 8, ...,
24 and 27. Each layer is pre-norm (RMSNorm) token mixing, then, pre-norm
again, a SiLU-gated MLP (layer 0, width 9,216) or a DeepSeekMoE layer
(sigmoid scores over 256 experts of width 1,024 with a correction bias, top
8, renormalised, times 2.446, one shared expert). MLA and the expert layer
are Moonlight's (`model.py`, shared): MLA here has no RoPE
(`mla_use_nope`): the 64-wide rope parts of the queries and the shared key
are used unrotated, and 576 values a position go into the latent cache.

KDA (the Kimi Linear report, arXiv:2510.26692, and flash-linear-attention's
`fla/layers/kda.py`), per head of 128 (32 heads), token t:
- q, k, v = SiLU(causal depthwise conv4(W_q x, W_k x, W_v x)); q and k
  L2-normalised per head, q scaled by 128^-1/2;
- g = -exp(A_log[h]) softplus(W_f_b W_f_a x + dt_bias), one log decay per
  key channel (alpha = exp(g)); beta = sigmoid(W_b x), one per head;
- S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,
  o_t = S_t^T q_t (S [128, 128] a head, fp32);
- out = W_o [RMSNorm_head(o_t) * sigmoid(W_g_b W_g_a x)] (ranks 128).

Prefill runs the recurrence in chunks of CHUNK (64) tokens (`kda_chunked`,
the WY/UT form with a per-channel decay): everything within a chunk is a
batched product over all chunks at once, and only the chunk-to-chunk state
update, S_{c+1} = P_c S_c + Q_c, runs in order (one batched product a
chunk). Decode runs the recurrence itself, one token a step. The
`HybridCache` holds both kinds of state: the latent entries of the 7 MLA
layers ([7, R, T, 576]), and for the 20 KDA layers the fp32 state ([20, R,
32, 128, 128], 42 MB a row) and each short conv's last 3 inputs.

A card may hold a share of each expert layer's experts (`num_experts` of
the router's `num_router_experts`, from `first_held_expert`), as expert
parallelism gives it; it routes over all of them and computes its own
experts' part (`model.moe`).

Decode runs a batch's rows at once; `decode_step` is one body launched op by
op (the CPU) or, on the HybridCache of a `decode_graph` (held by
models/step_graphs.py), a replay of its CUDA graph. Parameters are stored in
the serving type (bf16 on the card) except the router's weight and bias and
KDA's A_log and dt_bias (fp32). Spans and counters: `kda_chunks` (a
prefill's 64-token chunks summed over the KDA layers), `kda_state_bytes`
(the KDA state of a generation's rows); profiler ranges `llm.kda` and
`llm.mla` around each layer's token mixing in prefill.
"""
from __future__ import annotations

import math
from collections.abc import Iterable, Mapping
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from eioku_tpu_torch.models import step_graphs
from eioku_tpu_torch.models.llm import model as llm
from eioku_tpu_torch.utils.metrics import METRICS

CHUNK = 64  # KDA prefill's chunk of tokens
SUB = 16  # the chunk's sub-blocks, whose decays are taken from a point of their own
SEGMENT = 16384  # tokens of a row whose chunks run at once (the rest in turn)


@dataclass(frozen=True)
class KimiLinearConfig:
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    intermediate_size: int
    moe_intermediate_size: int
    num_experts: int
    num_experts_per_token: int
    num_shared_experts: int
    first_k_dense_replace: int
    routed_scaling_factor: float
    vocab_size: int
    rms_norm_eps: float
    model_max_length: int
    linear_attn_config: dict
    bos_token_id: int
    eos_token_id: int
    # the router's outputs where this card holds `num_experts` of them, from
    # `first_held_expert` (expert parallelism); None: it holds them all
    num_router_experts: int | None = None
    first_held_expert: int = 0
    mla_use_nope: bool = True
    moe_renormalize: bool = True
    q_lora_rank: int | None = None
    moe_layer_freq: int = 1
    moe_router_activation_func: str = "sigmoid"
    use_grouped_topk: bool = True
    num_expert_group: int = 1
    topk_group: int = 1
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"

    @classmethod
    def from_dict(cls, d: dict) -> "KimiLinearConfig":
        """The config from a `config.json`-style dict (other keys ignored);
        raises ValueError for a variant this model does not compute."""
        names = {f.name for f in fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in names})
        wrong = [f"{k}={getattr(cfg, k)!r}" for k, ok in (
            ("q_lora_rank", None), ("mla_use_nope", True), ("moe_layer_freq", 1),
            ("moe_router_activation_func", "sigmoid"), ("num_expert_group", 1),
            ("topk_group", 1), ("tie_word_embeddings", False), ("hidden_act", "silu"))
            if getattr(cfg, k) != ok]
        la = cfg.linear_attn_config
        every = sorted(la["full_attn_layers"] + la["kda_layers"])
        if every != list(range(1, cfg.num_hidden_layers + 1)):
            wrong.append(f"layer schedule {la['full_attn_layers']} + {la['kda_layers']}")
        if cfg.held_experts.stop > cfg.router_experts:
            wrong.append(f"held experts {cfg.held_experts} of {cfg.router_experts}")
        if wrong:
            raise ValueError(f"unsupported kimi_linear variant: {', '.join(wrong)}")
        return cfg

    # -- the names model.py's shared functions read --

    @property
    def num_experts_per_tok(self) -> int:
        return self.num_experts_per_token

    @property
    def norm_topk_prob(self) -> bool:
        return self.moe_renormalize

    @property
    def router_experts(self) -> int:
        return self.num_router_experts or self.num_experts

    @property
    def held_experts(self) -> range:
        return range(self.first_held_expert, self.first_held_expert + self.num_experts)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.qk_head_dim ** -0.5

    @property
    def context_length(self) -> int:
        return self.model_max_length

    # -- the layer schedule and KDA's sizes --

    @property
    def kinds(self) -> tuple[str, ...]:
        """Each layer's token mixing (0-based): "mla" or "kda"."""
        full = set(self.linear_attn_config["full_attn_layers"])
        return tuple("mla" if i + 1 in full else "kda" for i in range(self.num_hidden_layers))

    @property
    def latent_layers(self) -> int:
        return self.kinds.count("mla")

    @property
    def kda_heads(self) -> int:
        return self.linear_attn_config["num_heads"]

    @property
    def kda_head_dim(self) -> int:
        return self.linear_attn_config["head_dim"]

    @property
    def kda_width(self) -> int:
        return self.kda_heads * self.kda_head_dim

    @property
    def conv_size(self) -> int:
        return self.linear_attn_config["short_conv_kernel_size"]

    def is_dense(self, layer: int) -> bool:
        return layer < self.first_k_dense_replace


def _param(*shape: int, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


class KimiLayer(nn.Module):
    """One layer: `kind` "mla" (MoonlightLayer's attention parameters, so
    model.py's functions run it) or "kda"; `slot` its index among the
    layers of its kind (its place in the HybridCache)."""

    def __init__(self, cfg: KimiLinearConfig, kind: str, slot: int, dense: bool,
                 dtype: torch.dtype):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.kind, self.slot, self.dense = kind, slot, dense
        self.input_layernorm = _param(d, dtype=dtype)
        self.post_attention_layernorm = _param(d, dtype=dtype)
        if kind == "mla":
            # [q_nope of every head | c_kv | q_pe of every head | k_pe]
            self.qkv_a = _param(h * cfg.qk_head_dim + cfg.latent_dim, d, dtype=dtype)
            self.kv_a_layernorm = _param(cfg.kv_lora_rank, dtype=dtype)
            self.kv_b = _param(h * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank,
                               dtype=dtype)
            self.o_proj = _param(d, h * cfg.v_head_dim, dtype=dtype)
        else:
            w, r, hk = cfg.kda_width, cfg.kda_head_dim, cfg.kda_heads
            # q, k, v, f_a, g_a and b rows: one product of the normed input
            self.qkv_fgb = _param(3 * w + 2 * r + hk, d, dtype=dtype)
            self.conv = _param(3 * w, cfg.conv_size, dtype=dtype)  # q, k, v's depthwise taps
            self.f_b = _param(w, r, dtype=dtype)
            self.g_b = _param(w, r, dtype=dtype)
            self.A_log = _param(hk, dtype=torch.float32)
            self.dt_bias = _param(w, dtype=torch.float32)
            self.o_norm = _param(cfg.kda_head_dim, dtype=dtype)
            self.o_proj = _param(d, w, dtype=dtype)
        ffn = cfg.intermediate_size if dense else \
            cfg.moe_intermediate_size * cfg.num_shared_experts
        self.gate_up = _param(2 * ffn, d, dtype=dtype)
        self.down = _param(d, ffn, dtype=dtype)
        if not dense:
            e, m = cfg.num_experts, cfg.moe_intermediate_size
            self.router = _param(cfg.router_experts, d, dtype=torch.float32)
            self.router_bias = _param(cfg.router_experts, dtype=torch.float32)
            self.experts_gate_up = _param(e, 2 * m, d, dtype=dtype)
            self.experts_down = _param(e, d, m, dtype=dtype)


class KimiLinear(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        kinds = cfg.kinds
        self.embed_tokens = _param(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(
            KimiLayer(cfg, kind, kinds[:i].count(kind), cfg.is_dense(i), dtype)
            for i, kind in enumerate(kinds))
        self.norm = _param(cfg.hidden_size, dtype=dtype)
        self.lm_head = _param(cfg.vocab_size, cfg.hidden_size, dtype=dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def _tables(self) -> None:
        """Each expert layer's searchsorted keys 1..E held, on the device."""
        for layer in self.layers:
            if not layer.dense:
                layer.expert_ends = torch.arange(1, self.cfg.num_experts + 1, device=self.device)


def empty_model(cfg: KimiLinearConfig, dtype: torch.dtype, device) -> KimiLinear:
    """The model with uninitialised parameters on `device` (no other copy)."""
    with torch.device("meta"):
        model = KimiLinear(cfg, dtype)
    model = model.to_empty(device=device).eval()
    model._tables()
    return model


def init_random(cfg: KimiLinearConfig, dtype: torch.dtype, device, seed: int = 0) -> KimiLinear:
    """Random weights: normal(0, 0.02) matrices and conv taps, unit norms,
    zero biases and A_log (a decay of softplus(0) = 0.69 a step)."""
    model = empty_model(cfg, dtype, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(0.0 if name.endswith(("router_bias", "dt_bias", "A_log")) else 1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model


# -- the checkpoint's key names -------------------------------------------------------------


def _targets(model: KimiLinear) -> dict[str, tuple[torch.Tensor, torch.Tensor | None]]:
    """Checkpoint key -> (the part of a parameter it fills, and the row of
    that part each of its rows goes to, or None where the rows stay in
    order). A tensor of the same number of elements but another shape (a
    conv's [w, 1, 4], A_log's singleton dims) is reshaped to its part."""
    cfg = model.cfg
    nope, rope, h, lora = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.num_attention_heads, cfg.kv_lora_rank)
    pe = h * nope + lora  # the first rope row of qkv_a
    q_rows = torch.cat([torch.cat([i * nope + torch.arange(nope),
                                   pe + i * rope + torch.arange(rope)]) for i in range(h)])
    kv_a_rows = torch.cat([h * nope + torch.arange(lora), pe + h * rope + torch.arange(rope)])
    w, r = cfg.kda_width, cfg.kda_head_dim
    out = {"model.embed_tokens.weight": (model.embed_tokens, None),
           "model.norm.weight": (model.norm, None), "lm_head.weight": (model.lm_head, None)}
    for i, layer in enumerate(model.layers):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out.update({p + "input_layernorm.weight": (layer.input_layernorm, None),
                    p + "post_attention_layernorm.weight": (layer.post_attention_layernorm, None),
                    a + "o_proj.weight": (layer.o_proj, None)})
        if layer.kind == "mla":
            out.update({a + "q_proj.weight": (layer.qkv_a, q_rows),
                        a + "kv_a_proj_with_mqa.weight": (layer.qkv_a, kv_a_rows),
                        a + "kv_a_layernorm.weight": (layer.kv_a_layernorm, None),
                        a + "kv_b_proj.weight": (layer.kv_b, None)})
        else:
            rows = layer.qkv_fgb
            out.update({a + "q_proj.weight": (rows[:w], None),
                        a + "k_proj.weight": (rows[w:2 * w], None),
                        a + "v_proj.weight": (rows[2 * w:3 * w], None),
                        a + "f_a_proj.weight": (rows[3 * w:3 * w + r], None),
                        a + "g_a_proj.weight": (rows[3 * w + r:3 * w + 2 * r], None),
                        a + "b_proj.weight": (rows[3 * w + 2 * r:], None),
                        a + "q_conv1d.weight": (layer.conv[:w], None),
                        a + "k_conv1d.weight": (layer.conv[w:2 * w], None),
                        a + "v_conv1d.weight": (layer.conv[2 * w:], None),
                        a + "f_b_proj.weight": (layer.f_b, None),
                        a + "g_b_proj.weight": (layer.g_b, None),
                        a + "A_log": (layer.A_log, None), a + "dt_bias": (layer.dt_bias, None),
                        a + "o_norm.weight": (layer.o_norm, None)})
        mlp = p + ("mlp." if layer.dense else "mlp.shared_experts.")
        half = layer.gate_up.shape[0] // 2
        out.update({mlp + "gate_proj.weight": (layer.gate_up[:half], None),
                    mlp + "up_proj.weight": (layer.gate_up[half:], None),
                    mlp + "down_proj.weight": (layer.down, None)})
        if layer.dense:
            continue
        m = cfg.moe_intermediate_size
        out.update({p + "mlp.gate.weight": (layer.router, None),
                    p + "mlp.gate.e_score_correction_bias": (layer.router_bias, None)})
        for j, e in enumerate(cfg.held_experts):  # this card's experts only
            x = f"{p}mlp.experts.{e}."
            out.update({x + "gate_proj.weight": (layer.experts_gate_up[j, :m], None),
                        x + "up_proj.weight": (layer.experts_gate_up[j, m:], None),
                        x + "down_proj.weight": (layer.experts_down[j], None)})
    return out


def load_state_dict(model: KimiLinear,
                    state: Mapping[str, torch.Tensor] | Iterable[tuple[str, torch.Tensor]]
                    ) -> KimiLinear:
    """Copy a checkpoint in its own key names into `model` (as
    `model.load_state_dict` does for Moonlight): a mapping or an iterable
    of (name, tensor) pairs read once; the experts other cards hold and
    keys the model does not read are ignored. Raises KeyError naming
    parameters the checkpoint lacked, ValueError on a size."""
    targets = _targets(model)
    seen: set[str] = set()
    with torch.no_grad():
        for name, t in (state.items() if isinstance(state, Mapping) else state):
            if name not in targets:
                continue
            dst, rows = targets[name]
            want = tuple(dst.shape) if rows is None else (len(rows), *dst.shape[1:])
            if t.numel() != math.prod(want) or (t.dim() == len(want) and tuple(t.shape) != want):
                raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}, model {want}")
            t = t.reshape(want).to(device=dst.device, dtype=dst.dtype)
            if rows is None:
                dst.copy_(t)
            else:
                dst.index_copy_(0, rows.to(dst.device), t)
            seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"kimi_linear checkpoint lacks {len(missing)} tensors, e.g. {missing[:3]}")
    return model


# -- KDA ------------------------------------------------------------------------------------------


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """x / sqrt(sum x^2 + 1e-6) over the last dim (fla's `l2norm`)."""
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def kda_gates(layer: KimiLayer, cfg: KimiLinearConfig, a: torch.Tensor):
    """From the layer's input product a [N, 3w + 2r + H]: the log decay g
    [N, H, 128] = -exp(A_log) softplus(W_f_b f_a + dt_bias) and beta [N, H]
    = sigmoid(b), both fp32."""
    w, r, h = cfg.kda_width, cfg.kda_head_dim, cfg.kda_heads
    f = F.linear(a[:, 3 * w:3 * w + r], layer.f_b).float() + layer.dt_bias
    g = -layer.A_log.exp()[:, None] * F.softplus(f.view(-1, h, r))
    return g, a[:, 3 * w + 2 * r:].float().sigmoid()


def _kda_out(layer: KimiLayer, cfg: KimiLinearConfig, o: torch.Tensor,
             a: torch.Tensor) -> torch.Tensor:
    """o [N, H, 128] fp32 -> W_o [RMSNorm_head(o) * sigmoid(W_g_b g_a)]."""
    w, r, n = cfg.kda_width, cfg.kda_head_dim, o.shape[0]
    gate = F.linear(a[:, 3 * w + r:3 * w + 2 * r], layer.g_b).float().view(o.shape).sigmoid()
    o = F.rms_norm(o, (r,), weight=layer.o_norm.float(), eps=cfg.rms_norm_eps) * gate
    return F.linear(o.view(n, w).to(a.dtype), layer.o_proj)


def _qkv(cfg: KimiLinearConfig, mixed: torch.Tensor):
    """The short convs' outputs [N, 3w] -> q (normed, scaled), k (normed),
    v, each [N, H, 128] fp32."""
    h, r = cfg.kda_heads, cfg.kda_head_dim
    q, k, v = (t.float().reshape(-1, h, r) for t in F.silu(mixed).chunk(3, -1))
    return l2_norm(q) * r ** -0.5, l2_norm(k), v


def decayed_scores(a: torch.Tensor, b: torch.Tensor, G: torch.Tensor,
                   strict: bool) -> torch.Tensor:
    """Over chunks a, b, G [..., CHUNK, 128]: [..., CHUNK, CHUNK] with entry
    (t, s) = sum_c a[t, c] b[s, c] exp(G[t, c] - G[s, c]) for s < t
    (`strict`) or s <= t, zero elsewhere; G the chunk's cumulative log
    decay (non-increasing). The exponent is split at a point between s and
    t so that no factor overflows: for rows of sub-block i and earlier
    columns, at the last position before the sub-block (both factors <= 1);
    within a sub-block, at its middle (factors up to SUB / 2 steps of decay,
    exact below about 11 nats a step)."""
    out = a.new_zeros(*a.shape[:-1], CHUNK)
    keep = torch.ones(SUB, SUB, dtype=torch.bool, device=a.device).tril(-1 if strict else 0)
    for i in range(CHUNK // SUB):
        t = slice(i * SUB, (i + 1) * SUB)
        if i:
            ref = G[..., i * SUB - 1:i * SUB, :]
            out[..., t, :i * SUB] = (a[..., t, :] * (G[..., t, :] - ref).exp()) @ \
                (b[..., :i * SUB, :] * (ref - G[..., :i * SUB, :]).exp()).transpose(-1, -2)
        mid = G[..., i * SUB + SUB // 2 - 1:i * SUB + SUB // 2, :]
        d = (a[..., t, :] * (G[..., t, :] - mid).exp()) @ \
            (b[..., t, :] * (mid - G[..., t, :]).exp()).transpose(-1, -2)
        out[..., t, t] = d.masked_fill(~keep, 0)
    return out


def _kda_chunks(q, k, v, g, beta, state: torch.Tensor) -> torch.Tensor:
    """The recurrence over T tokens (a whole number of chunks), from and
    into `state` [H, 128, 128] fp32. q, k, v, g [T, H, 128], beta [T, H];
    returns o [T, H, 128]. Within chunk c, from its state S_c:
      u = T (beta v - beta K^+ S_c) with T = (I + A)^-1, A_ts = beta_t k_t .
        k_s e^{G_t - G_s} (s < t), K^+ = k e^{G}: U = Ut - W S_c;
      o = (q e^{G} - M W) S_c + M Ut, M_ts = q_t . k_s e^{G_t - G_s} (s <= t);
      S_{c+1} = (Diag e^{G_C} - Kd^T W) S_c + Kd^T Ut, Kd = k e^{G_C - G}."""
    t_len, h, dk = k.shape
    n = t_len // CHUNK

    def blocks(x: torch.Tensor) -> torch.Tensor:  # [T, H, ...] -> [n, H, CHUNK, ...]
        return x.view(n, CHUNK, h, *x.shape[2:]).transpose(1, 2)
    q, k, v, g, beta = (blocks(x) for x in (q, k, v, g, beta))
    G = g.cumsum(2)
    kb = k * beta[..., None]
    eG = G.exp()
    A = decayed_scores(kb, k, G, strict=True)
    M = decayed_scores(q, k, G, strict=False)
    wu = torch.linalg.solve_triangular(A, torch.cat([kb * eG, v * beta[..., None]], -1),
                                       upper=False, unitriangular=True)
    W, U = wu.split([dk, v.shape[-1]], -1)
    last = G[:, :, -1:, :]
    kd = (k * (last - G).exp()).transpose(-1, -2)
    P = torch.diag_embed(last.squeeze(2).exp()) - kd @ W
    Qs = kd @ U
    states = P.new_empty(n + 1, *state.shape)
    states[0] = state
    for c in range(n):
        torch.baddbmm(Qs[c], P[c], states[c], out=states[c + 1])
    state.copy_(states[n])
    o = (q * eG - M @ W) @ states[:n] + M @ U
    return o.transpose(1, 2).reshape(t_len, h, -1)


def kda_chunked(q, k, v, g, beta, state: torch.Tensor) -> torch.Tensor:
    """KDA over one row's T tokens from `state` (updated in place), in
    chunks of CHUNK, at most SEGMENT tokens' chunks at once. The tail is
    padded with tokens that leave the state as it is (k = v = 0, beta = 0,
    no decay)."""
    t_len = k.shape[0]
    pad = -t_len % CHUNK
    if pad:
        q, k, v, g = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v, g))
        beta = F.pad(beta, (0, 0, 0, pad))
    out = [_kda_chunks(q[s:s + SEGMENT], k[s:s + SEGMENT], v[s:s + SEGMENT], g[s:s + SEGMENT],
                       beta[s:s + SEGMENT], state) for s in range(0, t_len + pad, SEGMENT)]
    return torch.cat(out)[:t_len]


def _kda_prefill(layer: KimiLayer, cfg: KimiLinearConfig, x: torch.Tensor,
                 starts: list[int], lengths: list[int], cache: "HybridCache") -> torch.Tensor:
    """KDA over the packed rows of x [N, d] (normed), each row from a new
    state: writes each row's state and conv tail into the cache."""
    w, tail = cfg.kda_width, cfg.conv_size - 1
    a = F.linear(x, layer.qkv_fgb)
    g, beta = kda_gates(layer, cfg, a)
    o = torch.empty(x.shape[0], cfg.kda_heads, cfg.kda_head_dim, device=x.device)
    for row, (s, n) in enumerate(zip(starts, lengths)):
        seq = a[s:s + n, :3 * w].T  # [3w, n]
        mixed = F.conv1d(seq[None], layer.conv[:, None], padding=tail, groups=3 * w)[0, :, :n]
        kept = seq[:, max(n - tail, 0):]
        cache.conv[layer.slot, row, :, tail - kept.shape[1]:] = kept
        q, k, v = _qkv(cfg, mixed.T)
        o[s:s + n] = kda_chunked(q, k, v, g[s:s + n], beta[s:s + n],
                                 cache.state[layer.slot, row])
    return _kda_out(layer, cfg, o, a)


def _kda_step(layer: KimiLayer, cfg: KimiLinearConfig, x: torch.Tensor,
              cache: "HybridCache") -> torch.Tensor:
    """One token of every row (x [R, d], normed) through the recurrence, the
    conv tails and states updated in place."""
    w = cfg.kda_width
    a = F.linear(x, layer.qkv_fgb)
    g, beta = kda_gates(layer, cfg, a)
    tails = cache.conv[layer.slot]
    window = torch.cat([tails, a[:, :3 * w, None]], -1)  # [R, 3w, taps]
    tails.copy_(window[..., 1:])
    mixed = (window.float() * layer.conv.float()).sum(-1).to(x.dtype)
    q, k, v = _qkv(cfg, mixed)
    S = cache.state[layer.slot]  # [R, H, 128, 128]
    S.mul_(g.exp()[..., None])
    u = beta[..., None] * (v - (k[..., None, :] @ S).squeeze(-2))
    S.add_(k[..., :, None] * u[..., None, :])
    return _kda_out(layer, cfg, (q[..., None, :] @ S).squeeze(-2), a)


# -- prefill and decode -------------------------------------------------------------------


class HybridCache(llm.LatentCache):
    """A LatentCache over the MLA layers (`kv` [L_mla, R, T, 576]) with,
    beside it, the KDA layers' state: `state` [L_kda, R, H, 128, 128] fp32
    and `conv` [L_kda, R, 3w, taps - 1], each short conv's last inputs.
    Prefill writes both kinds; a decode step (eager or graphed) reads and
    updates both in place."""

    def __init__(self, cfg: KimiLinearConfig, rows: int, length: int, steps: int,
                 dtype: torch.dtype, device):
        super().__init__(cfg, rows, length, steps, dtype, device)
        kda = cfg.kinds.count("kda")
        r = cfg.kda_head_dim
        self.state = torch.zeros(kda, rows, cfg.kda_heads, r, r, dtype=torch.float32,
                                 device=device)
        self.conv = torch.zeros(kda, rows, 3 * cfg.kda_width, cfg.conv_size - 1, dtype=dtype,
                                device=device)
        self.positions = torch.arange(length, device=device)

    def reset(self) -> None:
        super().reset()
        self.state.zero_()
        self.conv.zero_()

    def copy_first_row(self, rows: int) -> None:
        if rows == self.kv.shape[1]:
            return
        super().copy_first_row(rows)
        self.state[:, rows:] = self.state[:, :1]
        self.conv[:, rows:] = self.conv[:, :1]

    @property
    def carried(self) -> tuple[torch.Tensor, ...]:
        """What a decode step updates from its own values (step_graphs.py)."""
        return self.state, self.conv

    def state_bytes(self, rows: int) -> int:
        """The KDA state (recurrent and conv) of `rows` rows, in bytes."""
        per_row = (self.state[:, 0].numel() * self.state.element_size()
                   + self.conv[:, 0].numel() * self.conv.element_size())
        return rows * per_row


@torch.no_grad()
def prefill(model: KimiLinear, ids: torch.Tensor, lengths: list[int],
            cache: HybridCache) -> torch.Tensor:
    """The rows' prompts, packed ([sum(lengths)] ids on the model's device,
    row after row), through every layer, each row from an empty state:
    fills the cache's first rows (latent entries at positions 0 .. length
    - 1, the KDA states and conv tails after the last) and returns the
    logits [R, V] (fp32) at each row's last prompt position."""
    cfg, dev = model.cfg, model.device
    rows, length = len(lengths), max(lengths)
    n = torch.tensor(lengths)
    pos = torch.cat([torch.arange(k) for k in lengths])
    row = torch.repeat_interleave(torch.arange(rows), n)
    pad_index, cache_index = torch.stack([row * length + pos, row * cache.length + pos]).to(dev)
    last = (n.cumsum(0) - 1).to(dev)
    starts = [0] + n.cumsum(0)[:-1].tolist()
    cache.prompt[:rows] = n.to(dev)
    eps = cfg.rms_norm_eps
    h = F.embedding(ids, model.embed_tokens)
    for layer in model.layers:
        x = llm.rms_norm(h, layer.input_layernorm, eps)
        if layer.kind == "mla":
            with record_function("llm.mla"):
                q_nope, q_pe, latent = llm._project(layer, cfg, x, None, None)
                cache.kv[layer.slot].view(-1, cfg.latent_dim).index_copy_(0, cache_index, latent)
                h = h + llm._attend_decompressed(layer, cfg, q_nope, q_pe, latent, pad_index,
                                                 rows, length)
        else:
            with record_function("llm.kda"):
                h = h + _kda_prefill(layer, cfg, x, starts, lengths, cache)
        x = llm.rms_norm(h, layer.post_attention_layernorm, eps)
        if layer.dense:
            h = h + llm._mlp(layer.gate_up, layer.down, x)
        else:
            y, _, ends = llm.moe(layer, cfg, x)
            cache.prefill_hits.add_(llm._groups_hit(ends))
            h = h + y
    METRICS.count("kda_chunks", cfg.kinds.count("kda") * sum(-(-k // CHUNK) for k in lengths))
    METRICS.count("kda_state_bytes", cache.state_bytes(rows))
    return llm._logits(model, h.index_select(0, last))


@torch.no_grad()
def _decode_eager(model: KimiLinear, cache: HybridCache) -> torch.Tensor:
    """The decode step's one body, at the cache's tokens and positions,
    launched op by op or captured."""
    cfg, pos, eps = model.cfg, cache.pos, model.cfg.rms_norm_eps
    valid = (cache.positions <= pos[:, None]).unsqueeze(1)
    column = pos - cache.prompt  # the step's column of the route log
    h = F.embedding(cache.tokens, model.embed_tokens)
    for i, layer in enumerate(model.layers):
        x = llm.rms_norm(h, layer.input_layernorm, eps)
        if layer.kind == "mla":
            q_nope, q_pe, latent = llm._project(layer, cfg, x, None, None)
            kv = cache.kv[layer.slot]
            kv.index_put_((cache.rows, pos), latent)
            h = h + llm._attend_absorbed(layer, cfg, q_nope, q_pe, kv, valid)
        else:
            h = h + _kda_step(layer, cfg, x, cache)
        x = llm.rms_norm(h, layer.post_attention_layernorm, eps)
        if layer.dense:
            h = h + llm._mlp(layer.gate_up, layer.down, x)
        else:
            y, chosen, _ = llm.moe(layer, cfg, x)
            cache.routes[i - cfg.first_k_dense_replace].index_put_((cache.rows, column), chosen)
            h = h + y
    return llm._logits(model, h)


def decode_step(model: KimiLinear, tokens: torch.Tensor, pos: torch.Tensor,
                cache: HybridCache) -> torch.Tensor:
    """One step of every row: tokens [R] at positions pos [R] (int64, on the
    device), through the absorbed MLA over the latent cache and the KDA
    recurrence on the states; logs each row's experts. Returns the logits
    [R, V] (fp32); on the cache of a `decode_graph` it replays the graph."""
    cache.tokens.copy_(tokens)
    cache.pos.copy_(pos)
    graph = step_graphs.holding(model, lambda buffers: buffers is cache)
    return _decode_eager(model, cache) if graph is None else graph.replay(model)


def make_cache(model: KimiLinear, rows: int, length: int, steps: int) -> HybridCache:
    """An eager generation's cache."""
    return HybridCache(model.cfg, rows, length, steps, model.dtype, model.device)


def decode_graph(model: KimiLinear, rows: int, length: int, steps: int):
    """A context that yields the model's graphed decode step of this shape
    (models/step_graphs.py `hand_out`; None while another generation holds
    it); its `buffers` are a HybridCache. Counters
    `llm_decode_graph_captures` and `llm_decode_graph_replays`."""
    return step_graphs.hand_out(model, (rows, length, steps),
                                lambda: make_cache(model, rows, length, steps),
                                _decode_eager, prefix="llm_")
