"""Moonlight-16B-A3B (huggingface.co/moonshotai/Moonlight-16B-A3B, its
`config.json`: `model_type` deepseek_v3) for prefill and greedy decode. No
counterpart in the JAX package.

The layer, as the checkpoint's `modeling_deepseek.py` computes it: pre-norm
(RMSNorm, eps 1e-5) latent attention, then, pre-norm again, a SiLU-gated MLP
(layer 0, width 11,264) or a DeepSeekMoE layer (layers 1-26).

- Latent attention (MLA, no q LoRA): `q_proj` gives per head q_nope (128)
  and q_pe (64); `kv_a_proj_with_mqa` gives the latent c_kv (512, then
  `kv_a_layernorm`) and one k_pe (64) shared by the heads; `kv_b_proj`
  expands c_kv into k_nope (128) and v (128) per head. RoPE (theta 50,000)
  reads q_pe and k_pe with their pairs interleaved, then rotates by halves
  (in the activations' type, as published); the loader folds that reading
  order into the rows of `q_proj` and `kv_a_proj_with_mqa` (an exact
  permutation), and lays the rows out so that one product gives
  [q_nope of every head | c_kv | q_pe of every head | k_pe]: the 17 rope
  parts are rotated at once. Scores are scaled by 192^-1/2; `o_proj` maps
  16 x 128 to 2048.
- The latent cache holds, per layer and position, the 576 values
  [normed c_kv | rotated k_pe]: 31.1 KB a token over 27 layers in bf16.
  Prefill decompresses keys and values through `kv_b_proj` and attends
  causally (`F.scaled_dot_product_attention` on the rows right-padded);
  decode absorbs `kv_b_proj`: its score is (q_nope W_UK) . c_kv + q_pe .
  k_pe over the whole cache, and W_UV is applied after the weighted sum of
  c_kv.
- Routed experts: 64 fp32 gate scores through the sigmoid; the top 6 are
  chosen on score plus `e_score_correction_bias` (`noaux_tc`, one group),
  weighted by the chosen scores without the bias, renormalised and
  multiplied by 2.446. Tokens are sorted by expert on the device and the
  experts run as a grouped GEMM (`torch._grouped_mm`) on the card, a loop
  over the experts on the CPU; nothing on the path reads a routing value
  back to the host. Two shared experts run as one MLP of width 2,816.

Decode runs a batch's rows at once; `decode_step` is one body launched op by
op (the CPU) or, on the LatentCache of a `decode_graph` (held by
models/step_graphs.py, the holder Whisper's decoder step shares), a replay
of its CUDA graph: the eager step is bound by the host's ~1,700 launches.
Each decode step logs the experts every row was routed to
(`LatentCache.routes`).

Parameters are stored in the serving type (bf16 on the card) except the
router's weight and bias (fp32, as the published gate computes). The
expert weights are stacked per layer ([E, 2 x 1408, 2048] gate and up,
[E, 2048, 1408] down); `load_state_dict` copies the checkpoint's own key
names into them one tensor at a time.
"""
from __future__ import annotations

import math
from collections.abc import Iterable, Mapping
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models import step_graphs

# moonshotai/Moonlight-16B-A3B's config.json, the keys this model reads
MOONLIGHT_16B_A3B = {
    "hidden_size": 2048, "num_hidden_layers": 27, "num_attention_heads": 16,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "n_routed_experts": 64, "num_experts_per_tok": 6,
    "n_shared_experts": 2, "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True, "scoring_func": "sigmoid",
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "vocab_size": 163840,
    "rms_norm_eps": 1e-5, "rope_theta": 50000.0, "max_position_embeddings": 8192,
    "tie_word_embeddings": False, "hidden_act": "silu", "rope_scaling": None,
    "bos_token_id": 163584, "eos_token_id": 163585, "model_type": "deepseek_v3",
}
# moonshotai/Kimi-Linear-48B-A3B-Instruct's config.json, the keys its model
# reads (models/llm/kimi_linear.py); BOS and EOS as Moonlight's tokenizer
# places them
KIMI_LINEAR_48B_A3B = {
    "hidden_size": 2304, "num_hidden_layers": 27, "num_attention_heads": 32,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "mla_use_nope": True,
    "intermediate_size": 9216, "moe_intermediate_size": 1024, "num_experts": 256,
    "num_experts_per_token": 8, "num_shared_experts": 1, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "routed_scaling_factor": 2.446, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "use_grouped_topk": True,
    "num_expert_group": 1, "topk_group": 1, "vocab_size": 163840, "rms_norm_eps": 1e-5,
    "model_max_length": 1048576, "tie_word_embeddings": False, "hidden_act": "silu",
    "linear_attn_config": {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
                           "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18,
                                          19, 21, 22, 23, 25, 26],
                           "num_heads": 32, "short_conv_kernel_size": 4},
    "bos_token_id": 163584, "eos_token_id": 163585, "model_type": "kimi_linear",
}
MODELS = {"moonlight-16b-a3b": MOONLIGHT_16B_A3B, "kimi-linear-48b-a3b": KIMI_LINEAR_48B_A3B}


@dataclass(frozen=True)
class MoonlightConfig:
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    intermediate_size: int
    moe_intermediate_size: int
    n_routed_experts: int
    num_experts_per_tok: int
    n_shared_experts: int
    first_k_dense_replace: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    vocab_size: int
    rms_norm_eps: float
    rope_theta: float
    max_position_embeddings: int
    bos_token_id: int
    eos_token_id: int
    q_lora_rank: int | None = None
    moe_layer_freq: int = 1
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    rope_scaling: dict | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "MoonlightConfig":
        """The config from a `config.json`-style dict (other keys ignored);
        raises ValueError for a variant this model does not compute."""
        names = {f.name for f in fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in names})
        wrong = [f"{k}={getattr(cfg, k)!r}" for k, ok in (
            ("q_lora_rank", None), ("moe_layer_freq", 1), ("scoring_func", "sigmoid"),
            ("topk_method", "noaux_tc"), ("n_group", 1), ("topk_group", 1),
            ("tie_word_embeddings", False), ("hidden_act", "silu"), ("rope_scaling", None))
            if getattr(cfg, k) != ok]
        if wrong:
            raise ValueError(f"unsupported deepseek_v3 variant: {', '.join(wrong)}")
        return cfg

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def q_width(self) -> int:
        return self.num_attention_heads * self.qk_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token a layer in the latent cache: c_kv and k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.qk_head_dim ** -0.5

    def is_dense(self, layer: int) -> bool:
        return layer < self.first_k_dense_replace

    # the MLA and expert functions below are shared with Kimi-Linear
    # (kimi_linear.py), whose config names these otherwise
    mla_use_nope = False

    @property
    def context_length(self) -> int:
        return self.max_position_embeddings

    @property
    def latent_layers(self) -> int:
        """Layers with entries in the latent cache: every layer."""
        return self.num_hidden_layers

    @property
    def router_experts(self) -> int:
        """The router's outputs: every expert of the layer."""
        return self.n_routed_experts

    @property
    def held_experts(self) -> range:
        """The experts whose weights this model holds: all of them."""
        return range(self.n_routed_experts)


def _param(*shape: int, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


class MoonlightLayer(nn.Module):
    def __init__(self, cfg: MoonlightConfig, dense: bool, dtype: torch.dtype):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.dense = dense
        self.input_layernorm = _param(d, dtype=dtype)
        self.post_attention_layernorm = _param(d, dtype=dtype)
        # q_proj's and kv_a_proj_with_mqa's rows as [q_nope of every head | c_kv |
        # q_pe of every head | k_pe]: one product of the normed input
        self.qkv_a = _param(cfg.q_width + cfg.latent_dim, d, dtype=dtype)
        self.kv_a_layernorm = _param(cfg.kv_lora_rank, dtype=dtype)
        self.kv_b = _param(h * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank,
                           dtype=dtype)
        self.o_proj = _param(d, h * cfg.v_head_dim, dtype=dtype)
        # the dense MLP (gate rows, then up rows), or the shared experts as one MLP
        ffn = cfg.intermediate_size if dense else cfg.moe_intermediate_size * cfg.n_shared_experts
        self.gate_up = _param(2 * ffn, d, dtype=dtype)
        self.down = _param(d, ffn, dtype=dtype)
        if not dense:
            e, m = cfg.n_routed_experts, cfg.moe_intermediate_size
            self.router = _param(e, d, dtype=torch.float32)
            self.router_bias = _param(e, dtype=torch.float32)
            self.experts_gate_up = _param(e, 2 * m, d, dtype=dtype)
            self.experts_down = _param(e, d, m, dtype=dtype)


class Moonlight(nn.Module):
    def __init__(self, cfg: MoonlightConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = _param(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(MoonlightLayer(cfg, cfg.is_dense(i), dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = _param(cfg.hidden_size, dtype=dtype)
        self.lm_head = _param(cfg.vocab_size, cfg.hidden_size, dtype=dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def _tables(self) -> None:
        """RoPE's cos and sin per position ([positions, 64] fp32, the halves
        repeated), the position ids, and each expert layer's searchsorted
        keys 1..E (group e ends at the count of pairs below e + 1), on the
        model's device."""
        cfg, dev = self.cfg, self.device
        r = cfg.qk_rope_head_dim
        inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                                      device=dev) / r))
        t = torch.arange(cfg.max_position_embeddings, dtype=torch.float32, device=dev)
        emb = torch.outer(t, inv).repeat(1, 2)
        self.rope_cos, self.rope_sin = emb.cos(), emb.sin()
        self.positions = torch.arange(cfg.max_position_embeddings, device=dev)
        for layer in self.layers:
            if not layer.dense:
                layer.expert_ends = torch.arange(1, cfg.n_routed_experts + 1, device=dev)


def empty_model(cfg: MoonlightConfig, dtype: torch.dtype, device) -> Moonlight:
    """The model with uninitialised parameters on `device` (no other copy)."""
    with torch.device("meta"):
        model = Moonlight(cfg, dtype)
    model = model.to_empty(device=device).eval()
    model._tables()
    return model


def init_random(cfg: MoonlightConfig, dtype: torch.dtype, device, seed: int = 0) -> Moonlight:
    """Random weights (the published init: normal(0, 0.02) matrices, unit
    norms, a zero correction bias), drawn on `device`."""
    model = empty_model(cfg, dtype, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(0.0 if name.endswith("router_bias") else 1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model


# -- the checkpoint's key names -------------------------------------------------------------


def _rope_order(n: int) -> torch.Tensor:
    """The order in which `modeling_deepseek.py` reads a rope vector of n
    values before rotating it by halves: even entries, then odd ones."""
    return torch.cat([torch.arange(0, n, 2), torch.arange(1, n, 2)])


def _targets(model: Moonlight) -> dict[str, tuple[torch.Tensor, torch.Tensor | None]]:
    """Checkpoint key -> (the part of a parameter it fills, and the row of
    that part each of its rows goes to, or None where the rows stay in
    order)."""
    cfg = model.cfg
    nope, rope, h, lora = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.num_attention_heads, cfg.kv_lora_rank)
    # where each row of a rope part goes: its pairs' even entries first
    dest = torch.empty(rope, dtype=torch.long)
    dest[_rope_order(rope)] = torch.arange(rope)
    pe = h * nope + lora  # the first rope row of qkv_a
    q_rows = torch.cat([torch.cat([i * nope + torch.arange(nope), pe + i * rope + dest])
                        for i in range(h)])
    kv_a_rows = torch.cat([h * nope + torch.arange(lora), pe + h * rope + dest])
    out = {"model.embed_tokens.weight": (model.embed_tokens, None),
           "model.norm.weight": (model.norm, None), "lm_head.weight": (model.lm_head, None)}
    for i, layer in enumerate(model.layers):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (layer.input_layernorm, None),
            p + "post_attention_layernorm.weight": (layer.post_attention_layernorm, None),
            p + "self_attn.q_proj.weight": (layer.qkv_a, q_rows),
            p + "self_attn.kv_a_proj_with_mqa.weight": (layer.qkv_a, kv_a_rows),
            p + "self_attn.kv_a_layernorm.weight": (layer.kv_a_layernorm, None),
            p + "self_attn.kv_b_proj.weight": (layer.kv_b, None),
            p + "self_attn.o_proj.weight": (layer.o_proj, None)})
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
        for e in range(cfg.n_routed_experts):
            x = f"{p}mlp.experts.{e}."
            out.update({x + "gate_proj.weight": (layer.experts_gate_up[e, :m], None),
                        x + "up_proj.weight": (layer.experts_gate_up[e, m:], None),
                        x + "down_proj.weight": (layer.experts_down[e], None)})
    return out


def load_state_dict(model: Moonlight,
                    state: Mapping[str, torch.Tensor] | Iterable[tuple[str, torch.Tensor]]
                    ) -> Moonlight:
    """Copy a checkpoint in its own key names (`model.layers.{i}.mlp.
    experts.{e}.gate_proj.weight`, ...) into `model`, converting each tensor
    to its parameter's type and device. `state` is a mapping or an iterable
    of (name, tensor) pairs read once, so a caller that yields them layer by
    layer (or shard by shard) never holds a second copy of the model. Keys
    the model does not read (rotary buffers) are ignored; raises KeyError
    naming parameters the checkpoint lacked, ValueError on a shape."""
    targets = _targets(model)
    seen: set[str] = set()
    with torch.no_grad():
        for name, t in (state.items() if isinstance(state, Mapping) else state):
            if name not in targets:
                continue
            dst, rows = targets[name]
            want = tuple(dst.shape) if rows is None else (len(rows), *dst.shape[1:])
            if tuple(t.shape) != want:
                raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}, model {want}")
            t = t.to(device=dst.device, dtype=dst.dtype)
            if rows is None:
                dst.copy_(t)
            else:
                dst.index_copy_(0, rows.to(dst.device), t)
            seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"moonlight checkpoint lacks {len(missing)} tensors, e.g. {missing[:3]}")
    return model


# -- the layer's pieces ------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm, its statistics in fp32 whatever the input's type (one fused
    kernel on the card)."""
    return F.rms_norm(x, (x.shape[-1],), weight=w, eps=eps)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., r] (already in the rotation's order) rotated by halves."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def _project(layer: MoonlightLayer, cfg: MoonlightConfig, x: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor):
    """Normed input [N, d] -> q_nope [N, H, 128], rotated q_pe [N, H, 64] and
    the latent entry [N, 576] (normed c_kv, rotated k_pe); cos and sin
    [N, 64] in the activations' type (unread with `mla_use_nope`)."""
    n, h = x.shape[0], cfg.num_attention_heads
    nope, lora = h * cfg.qk_nope_head_dim, cfg.kv_lora_rank
    a = F.linear(x, layer.qkv_a)
    pe = a[:, nope + lora:].view(n, h + 1, cfg.qk_rope_head_dim)
    if not cfg.mla_use_nope:  # with mla_use_nope the rope part is not rotated
        pe = _rope(pe, cos[:, None], sin[:, None])
    c_kv = rms_norm(a[:, nope:nope + lora], layer.kv_a_layernorm, cfg.rms_norm_eps)
    return (a[:, :nope].view(n, h, cfg.qk_nope_head_dim), pe[:, :h],
            torch.cat([c_kv, pe[:, h]], -1))


def _attend_decompressed(layer: MoonlightLayer, cfg: MoonlightConfig, q_nope, q_pe, latent,
                         pad_index: torch.Tensor, rows: int, length: int) -> torch.Tensor:
    """Prefill: keys and values decompressed through kv_b_proj, each row
    attending causally over its own tokens. The packed tokens [N] go into
    rows right-padded to `length` at `pad_index`; a real position never
    sees a padded one, which lies after it."""
    n, h = latent.shape[0], cfg.num_attention_heads
    lora, nope, vd = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    kv = F.linear(latent[:, :lora], layer.kv_b).view(n, h, nope + vd)
    k_nope, v = kv.split([nope, vd], -1)
    k = torch.cat([k_nope, latent[:, None, lora:].expand(n, h, cfg.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_pe], -1)

    def padded(t: torch.Tensor) -> torch.Tensor:
        out = t.new_zeros(rows * length, h, t.shape[-1]).index_copy_(0, pad_index, t)
        return out.view(rows, length, h, -1).transpose(1, 2)
    o = F.scaled_dot_product_attention(padded(q), padded(k), padded(v), is_causal=True,
                                       scale=cfg.softmax_scale)
    o = o.transpose(1, 2).reshape(rows * length, h * vd).index_select(0, pad_index)
    return F.linear(o, layer.o_proj)


def _attend_absorbed(layer: MoonlightLayer, cfg: MoonlightConfig, q_nope, q_pe,
                     kv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Decode: kv_b_proj absorbed. kv is the layer's cache [R, T, 576] with
    this step's entries written; valid [R, 1, T] marks each row's positions
    up to its own. The score of a cached position is (q_nope W_UK) . c_kv +
    q_pe . k_pe in one product over the 576 values; W_UV follows the
    weighted sum of c_kv."""
    r, h = kv.shape[0], cfg.num_attention_heads
    lora, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    w = layer.kv_b.view(h, nope + cfg.v_head_dim, lora)
    q_lat = torch.bmm(q_nope.transpose(0, 1), w[:, :nope])           # [H, R, 512]
    q = torch.cat([q_lat.transpose(0, 1), q_pe], -1)                  # [R, H, 576]
    s = torch.bmm(q, kv.transpose(1, 2)).float() * cfg.softmax_scale  # [R, H, T]
    p = s.masked_fill(~valid, -math.inf).softmax(-1)
    ctx = torch.bmm(p.to(kv.dtype), kv[..., :lora])                   # [R, H, 512]
    o = torch.bmm(ctx.transpose(0, 1), w[:, nope:].transpose(1, 2))   # [H, R, 128]
    return F.linear(o.transpose(0, 1).reshape(r, h * cfg.v_head_dim), layer.o_proj)


def _mlp(gate_up: torch.Tensor, down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    g, u = F.linear(x, gate_up).chunk(2, -1)
    return F.linear(F.silu(g) * u, down)


def route(layer: MoonlightLayer, cfg: MoonlightConfig, x: torch.Tensor):
    """(weights [N, k] fp32, experts [N, k]): sigmoid scores of the fp32
    gate; the top k chosen on score plus the correction bias, weighted by
    the scores alone, renormalised and scaled."""
    scores = F.linear(x.float(), layer.router).sigmoid()
    experts = torch.topk(scores + layer.router_bias, cfg.num_experts_per_tok, dim=-1,
                         sorted=False).indices
    w = scores.gather(1, experts)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor, experts


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """x [M, K] with its rows grouped by expert (group e ends at row
    ends[e], int32), w [E, N, K] -> [M, N]: each group times its expert's
    w[e]^T. One grouped GEMM on the card; a loop over the experts on the
    CPU."""
    if x.is_cuda:
        return torch._grouped_mm(x, w.transpose(1, 2), offs=ends)
    out = x.new_empty(x.shape[0], w.shape[1])
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].T
        start = end
    return out


def routed_experts(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """The held experts on their tokens: x [M, d] sorted by expert, group e
    ending at row ends[e]; gate_up [E, 2m, d], down [E, d, m] -> [M, d]."""
    g, u = grouped_mm(x, gate_up, ends).chunk(2, -1)
    return grouped_mm(F.silu(g) * u, down, ends)


def moe(layer: MoonlightLayer, cfg: MoonlightConfig, x: torch.Tensor):
    """DeepSeekMoE on x [N, d]: each token's k routed experts, weighted and
    summed in fp32, plus the shared experts. The token-expert pairs are
    sorted by expert on the device. Returns (output [N, d], the experts
    chosen [N, k], the group ends int32 [E held]).

    A layer that holds a share of the experts (`cfg.held_experts`, a range
    of the router's outputs, as expert parallelism gives each card) routes
    over all of them and computes its own experts' part: pairs routed
    elsewhere sort after every group, the grouped GEMMs leave them out and
    their rows are zeroed before the weighted sum."""
    n, k = x.shape[0], cfg.num_experts_per_tok
    w, chosen = route(layer, cfg, x)
    held = cfg.held_experts
    key = chosen.reshape(-1)
    partial = len(held) < cfg.router_experts
    if partial:
        local = key - held.start
        key = torch.where((local >= 0) & (local < len(held)), local, len(held))
    by_expert, order = torch.sort(key, stable=True)
    ends = torch.searchsorted(by_expert, layer.expert_ends, out_int32=True)
    y = routed_experts(x.index_select(0, order // k), layer.experts_gate_up,
                       layer.experts_down, ends)
    if partial:  # rows past the last group: pairs of experts held elsewhere
        y.masked_fill_(torch.arange(y.shape[0], device=y.device)[:, None] >= ends[-1], 0)
    y = torch.empty_like(y).index_copy_(0, order, y).view(n, k, -1)
    routed = (y.float() * w.unsqueeze(-1)).sum(1).to(x.dtype)
    return routed + _mlp(layer.gate_up, layer.down, x), chosen, ends


def _logits(model: Moonlight, h: torch.Tensor) -> torch.Tensor:
    return F.linear(rms_norm(h, model.norm, model.cfg.rms_norm_eps), model.lm_head).float()


# -- prefill and decode -------------------------------------------------------------------


class LatentCache:
    """One generation's state on the device: per latent-attention layer and
    row, the latent entries of `length` positions ([L, R, T, 576], zeros
    where nothing was written); each row's prompt length; the experts each
    decode step routed each row to, by expert layer (`routes` [L_moe, R,
    steps, k]); the held experts the prefill's expert-layer calls gave at
    least one token (a device count); and the step's tokens and positions
    [R], which a graphed step reads (`decode_graph`)."""

    def __init__(self, cfg: MoonlightConfig, rows: int, length: int, steps: int,
                 dtype: torch.dtype, device):
        if length > cfg.context_length:
            raise ValueError(f"{length} positions, past the model's {cfg.context_length}")
        moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
        self.kv = torch.zeros(cfg.latent_layers, rows, length, cfg.latent_dim,
                              dtype=dtype, device=device)
        self.rows = torch.arange(rows, device=device)
        self.prompt = torch.zeros(rows, dtype=torch.long, device=device)
        self.routes = torch.zeros(moe_layers, rows, max(steps, 1), cfg.num_experts_per_tok,
                                  dtype=torch.long, device=device)
        self.prefill_hits = torch.zeros((), dtype=torch.long, device=device)
        self.tokens = torch.zeros(rows, dtype=torch.long, device=device)
        self.pos = torch.zeros(rows, dtype=torch.long, device=device)
        self.n_experts = cfg.router_experts
        self.held = cfg.held_experts
        self.length = length

    def reset(self) -> None:
        """Empty for a new generation (a graph's buffers are reused)."""
        for t in (self.kv, self.prompt, self.routes, self.prefill_hits):
            t.zero_()

    def copy_first_row(self, rows: int) -> None:
        """Rows `rows`.. become copies of row 0 (entries and prompt length):
        rows that pad a batch to a graph's width compute what row 0 does,
        and so route to its experts."""
        if rows == self.kv.shape[1]:
            return
        self.kv[:, rows:] = self.kv[:, :1]
        self.prompt[rows:] = self.prompt[0]

    def experts_hit(self, rows: int, steps: int) -> int:
        """Held experts given at least one token, summed over the
        expert-layer calls of the prefill and of `steps` decode steps of the
        first `rows` rows: one read of the device."""
        moe_layers = self.routes.shape[0]
        routes = self.routes[:, :rows, :steps].transpose(1, 2).reshape(moe_layers, steps, -1)
        hit = torch.zeros(moe_layers, steps, self.n_experts, dtype=torch.bool,
                          device=routes.device).scatter_(2, routes, True)
        return int(self.prefill_hits + hit[..., self.held.start:self.held.stop].sum())


def _groups_hit(ends: torch.Tensor) -> torch.Tensor:
    """The groups of int32 ends [E] that hold at least one row (a device
    count)."""
    return torch.diff(ends, prepend=ends.new_zeros(1)).gt(0).sum()


@torch.no_grad()
def prefill(model: Moonlight, ids: torch.Tensor, lengths: list[int],
            cache: LatentCache) -> torch.Tensor:
    """The rows' prompts, packed ([sum(lengths)] ids on the model's device,
    row after row), through every layer: fills the cache's first rows at
    positions 0 .. length - 1 through the decompressing path and returns
    the logits [R, V] (fp32) at each row's last prompt position."""
    cfg, dev = model.cfg, model.device
    rows, length = len(lengths), max(lengths)
    n = torch.tensor(lengths)
    pos = torch.cat([torch.arange(k) for k in lengths])
    row = torch.repeat_interleave(torch.arange(rows), n)
    index = torch.stack([pos, row * length + pos, row * cache.length + pos]).to(dev)
    pos, pad_index, cache_index = index
    last = (n.cumsum(0) - 1).to(dev)
    cache.prompt[:rows] = n.to(dev)
    cos, sin = model.rope_cos[pos].to(model.dtype), model.rope_sin[pos].to(model.dtype)
    h = F.embedding(ids, model.embed_tokens)
    for i, layer in enumerate(model.layers):
        q_nope, q_pe, latent = _project(
            layer, cfg, rms_norm(h, layer.input_layernorm, cfg.rms_norm_eps), cos, sin)
        cache.kv[i].view(-1, cfg.latent_dim).index_copy_(0, cache_index, latent)
        h = h + _attend_decompressed(layer, cfg, q_nope, q_pe, latent, pad_index, rows, length)
        x = rms_norm(h, layer.post_attention_layernorm, cfg.rms_norm_eps)
        if layer.dense:
            h = h + _mlp(layer.gate_up, layer.down, x)
        else:
            y, _, ends = moe(layer, cfg, x)
            cache.prefill_hits.add_(_groups_hit(ends))
            h = h + y
    return _logits(model, h.index_select(0, last))


@torch.no_grad()
def _decode_eager(model: Moonlight, cache: LatentCache) -> torch.Tensor:
    """The decode step's one body, at the cache's tokens and positions,
    launched op by op or captured."""
    cfg, pos = model.cfg, cache.pos
    cos, sin = model.rope_cos[pos].to(model.dtype), model.rope_sin[pos].to(model.dtype)
    valid = (model.positions[:cache.length] <= pos[:, None]).unsqueeze(1)
    column = pos - cache.prompt  # the step's column of the route log
    h = F.embedding(cache.tokens, model.embed_tokens)
    for i, layer in enumerate(model.layers):
        q_nope, q_pe, latent = _project(
            layer, cfg, rms_norm(h, layer.input_layernorm, cfg.rms_norm_eps), cos, sin)
        cache.kv[i].index_put_((cache.rows, pos), latent)
        h = h + _attend_absorbed(layer, cfg, q_nope, q_pe, cache.kv[i], valid)
        x = rms_norm(h, layer.post_attention_layernorm, cfg.rms_norm_eps)
        if layer.dense:
            h = h + _mlp(layer.gate_up, layer.down, x)
        else:
            y, chosen, _ = moe(layer, cfg, x)
            cache.routes[i - cfg.first_k_dense_replace].index_put_((cache.rows, column), chosen)
            h = h + y
    return _logits(model, h)


def decode_step(model: Moonlight, tokens: torch.Tensor, pos: torch.Tensor,
                cache: LatentCache) -> torch.Tensor:
    """One step of every row: tokens [R] at positions pos [R] (int64, on the
    device). Writes each row's latent entry at its position, attends
    through the absorbed path over the whole cache (positions past the
    row's own masked) and logs the experts each row was routed to. Returns
    the logits [R, V] (fp32). Reads nothing back to the host; on the cache
    of a `decode_graph` it replays the graph."""
    cache.tokens.copy_(tokens)
    cache.pos.copy_(pos)
    graph = step_graphs.holding(model, lambda buffers: buffers is cache)
    return _decode_eager(model, cache) if graph is None else graph.replay(model)


def make_cache(model: Moonlight, rows: int, length: int, steps: int) -> LatentCache:
    """An eager generation's cache."""
    return LatentCache(model.cfg, rows, length, steps, model.dtype, model.device)


def decode_graph(model: Moonlight, rows: int, length: int, steps: int):
    """A context that yields the model's graphed decode step of this shape
    for one generation (models/step_graphs.py `hand_out`), or None while
    another generation holds it (that one decodes eagerly). Its `buffers`
    are a LatentCache that the generations of this shape reuse. Counters
    `llm_decode_graph_captures` and `llm_decode_graph_replays`."""
    return step_graphs.hand_out(
        model, (rows, length, steps),
        lambda: LatentCache(model.cfg, rows, length, steps, model.dtype, model.device),
        _decode_eager, prefix="llm_")
