"""Kimi-Linear-48B-A3B in the port (`models/llm/kimi_linear.py`,
`ml/summarize.py`) against its plain float32 reference
(`models/llm/kimi_linear_reference.py`), at a tiny size on the CPU: KDA's
chunked prefill against the token recurrence, prefill then decode through
the hybrid cache against the full forward, the expert layer's shares, the
checkpoint's key names, the `summarization` task through the engine, and
Moonlight's shared code left as it was.

The tiny model keeps every mechanism: the published schedule's first
period (three KDA layers, then MLA without RoPE), a dense first layer,
expert layers of 8 experts (top 2, one shared, a correction bias), a
vocabulary with the specials at its top. Parity is held to 1e-4 of the
largest reference value: float32 on both sides, sums taken in other orders.
"""
from __future__ import annotations

import math

import pytest
import torch

from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.llm import kimi_linear as kimi
from eioku_tpu_torch.models.llm import kimi_linear_reference as ref
from eioku_tpu_torch.models.llm import model as llm
from eioku_tpu_torch.utils.metrics import METRICS

TINY = {**llm.KIMI_LINEAR_48B_A3B,
        "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "intermediate_size": 128, "moe_intermediate_size": 32, "num_experts": 8,
        "num_experts_per_token": 2, "num_shared_experts": 1, "first_k_dense_replace": 1,
        "vocab_size": 512, "model_max_length": 512, "bos_token_id": 256, "eos_token_id": 257,
        "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3], "head_dim": 16,
                               "num_heads": 4, "short_conv_kernel_size": 4}}
RTOL = 1e-4


def seeded_state(cfg: dict, seed: int = 0) -> dict[str, torch.Tensor]:
    """Float32 weights in the checkpoint's names: matrices of std
    1/sqrt(in), norms near 1, a correction bias of the scores' order, token
    rows of std 1 in and 1/sqrt(d) out, conv taps of std 1/2, and decays of
    0.25-0.999 a step (A_log near 0, dt_bias from -7 to 0)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.checkpoint_shapes(cfg):
        x = torch.randn(shape, generator=gen)
        if name.endswith("e_score_correction_bias"):
            x = x * 0.1
        elif name.endswith("A_log"):
            x = x * 0.1
        elif name.endswith("dt_bias"):
            x = torch.rand(shape, generator=gen) * -7
        elif name.endswith("conv1d.weight"):
            x = x * 0.5
        elif len(shape) == 1:
            x = 1 + 0.1 * x
        elif name != "model.embed_tokens.weight":
            x = x / math.sqrt(shape[1])
        out[name] = x
    return out


def _model(cfg: dict, state: dict, dtype=torch.float32, device="cpu") -> kimi.KimiLinear:
    return kimi.load_state_dict(kimi.empty_model(kimi.KimiLinearConfig.from_dict(cfg), dtype,
                                                 device), state)


@pytest.fixture(scope="module")
def tiny():
    state = seeded_state(TINY)
    return _model(TINY, state), state


def _close(a: torch.Tensor, b: torch.Tensor) -> None:
    err = float((a - b).abs().max())
    assert err <= RTOL * float(b.abs().max()), err


def _kda_inputs(t: int, h: int = 3, d: int = 16, strong: bool = False, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    q, k = (ref.l2_norm(torch.randn(t, h, d, generator=gen)) for _ in range(2))
    v = torch.randn(t, h, d, generator=gen)
    # a decay of 0.9-0.999 a step, or down to e^-8 on some channels
    low = 8.0 if strong else 0.1
    g = -torch.rand(t, h, d, generator=gen) ** 3 * low - 0.001
    beta = torch.rand(t, h, generator=gen)
    return q * d ** -0.5, k, v, g, beta


@pytest.mark.parametrize("length,strong,segment", [
    (1, False, None), (5, False, None), (63, False, None), (64, False, None), (65, False, None),
    (130, False, None), (200, True, None), (300, False, 128)])
def test_chunked_prefill_matches_the_token_recurrence(length, strong, segment, monkeypatch):
    """Outputs at every token and the last state, from a nonzero state, at
    lengths around the chunk's 64; with strong decays; and with rows split
    into segments of chunks carried by the state."""
    if segment:
        monkeypatch.setattr(kimi, "SEGMENT", segment)
    q, k, v, g, beta = _kda_inputs(length, strong=strong)
    s0 = torch.randn(3, 16, 16, generator=torch.Generator().manual_seed(9)) * 0.1
    want, last = ref.recurrence(q, k, v, g, beta, s0.clone())
    state = s0.clone()
    got = kimi.kda_chunked(q, k, v, g, beta, state)
    _close(got, want)
    _close(state, last)


def test_decayed_scores_match_the_pairwise_form():
    q, k, _, g, _ = _kda_inputs(2 * kimi.CHUNK, strong=True)
    blocks = [x.view(2, kimi.CHUNK, 3, 16).transpose(1, 2) for x in (q, k, g)]
    G = blocks[2].cumsum(2)
    for strict in (True, False):
        got = kimi.decayed_scores(blocks[0], blocks[1], G, strict)
        diff = (G[:, :, :, None, :] - G[:, :, None, :, :]).clamp_max(0).exp()
        want = torch.einsum("nhtc,nhsc,nhtsc->nhts", blocks[0], blocks[1], diff)
        want = want.tril(-1 if strict else 0)
        _close(got, want)


PROMPTS = [[256, 5, 77, 3, 9, 200, 41, 18, 60, 2, 11], [256, 300, 7, 7, 150],
           [256] + list(range(1, 80))]


@pytest.mark.parametrize("rows", [[0], [1, 2], [2, 0, 1]])
def test_prefill_then_decode_matches_the_full_forward(tiny, rows):
    """Prefill of packed rows (the longest past a chunk), then 6 graphless
    decode steps through the hybrid cache feeding fixed ids: the logits at
    every emitted position equal the reference's full forward over prompt
    plus fed ids."""
    model, state = tiny
    prompts = [PROMPTS[r] for r in rows]
    steps = 6
    fed = torch.randint(0, 256, (len(prompts), steps), generator=torch.Generator().manual_seed(1))
    lengths = [len(p) for p in prompts]
    cache = kimi.make_cache(model, len(prompts), max(lengths) + steps, steps)
    got = [kimi.prefill(model, torch.tensor([t for p in prompts for t in p]), lengths, cache)]
    pos = torch.tensor(lengths)
    for t in range(steps):
        got.append(kimi.decode_step(model, fed[:, t], pos, cache))
        pos = pos + 1
    for r, p in enumerate(prompts):
        seq = p + fed[r].tolist()
        want = ref.forward(state, TINY, seq, list(range(len(p) - 1, len(seq))))
        for t in range(steps + 1):
            _close(got[t][r], want[t])


@pytest.mark.parametrize("shares", [2, 4])
def test_expert_shares_add_up_to_the_uncut_layer(tiny, shares):
    """Each share of the experts (a card of expert parallelism) routes over
    all 8 and computes its own experts' part; the parts of every share, the
    shared expert counted once, add up to the uncut reference's layer."""
    _, state = tiny
    x = torch.randn(40, TINY["hidden_size"], generator=torch.Generator().manual_seed(3))
    pre = "model.layers.2."
    n = TINY["num_experts"] // shares
    parts = []
    for i in range(shares):
        cfg = {**TINY, "num_experts": n, "num_router_experts": TINY["num_experts"],
               "first_held_expert": i * n}
        model = _model(cfg, state)
        y, chosen, ends = llm.moe(model.layers[2], model.cfg, x)
        held = (chosen >= i * n) & (chosen < (i + 1) * n)
        assert int(ends[-1]) == int(held.sum())
        parts.append(y)
        _close(y, ref.routed(x, state, pre, cfg, range(i * n, (i + 1) * n))
               + ref.mlp(x, state, pre + "mlp.shared_experts."))
    shared = ref.mlp(x, state, pre + "mlp.shared_experts.")
    want = ref.routed(x, state, pre, TINY, range(TINY["num_experts"])) + shared
    _close(sum(parts) - (shares - 1) * shared, want)


def _moonlight():
    from tests.test_torch_llm import TINY as MOON
    from tests.test_torch_llm import seeded_state as moon_state
    cfg = llm.MoonlightConfig.from_dict(MOON)
    return llm.load_state_dict(llm.empty_model(cfg, torch.float32, "cpu"), moon_state(MOON)), cfg


def _project_before(layer, cfg, x, cos, sin):
    """model.py's `_project` before the NoPE flag, verbatim."""
    n, h = x.shape[0], cfg.num_attention_heads
    nope, lora = h * cfg.qk_nope_head_dim, cfg.kv_lora_rank
    a = torch.nn.functional.linear(x, layer.qkv_a)
    pe = llm._rope(a[:, nope + lora:].view(n, h + 1, cfg.qk_rope_head_dim), cos[:, None],
                   sin[:, None])
    c_kv = llm.rms_norm(a[:, nope:nope + lora], layer.kv_a_layernorm, cfg.rms_norm_eps)
    return (a[:, :nope].view(n, h, cfg.qk_nope_head_dim), pe[:, :h],
            torch.cat([c_kv, pe[:, h]], -1))


def _moe_before(layer, cfg, x):
    """model.py's `moe` before the held range, verbatim."""
    n, k = x.shape[0], cfg.num_experts_per_tok
    w, chosen = llm.route(layer, cfg, x)
    by_expert, order = torch.sort(chosen.reshape(-1), stable=True)
    ends = torch.searchsorted(by_expert, layer.expert_ends, out_int32=True)
    y = llm.routed_experts(x.index_select(0, order // k), layer.experts_gate_up,
                           layer.experts_down, ends)
    y = torch.empty_like(y).index_copy_(0, order, y).view(n, k, -1)
    routed = (y.float() * w.unsqueeze(-1)).sum(1).to(x.dtype)
    return routed + llm._mlp(layer.gate_up, layer.down, x), chosen, ends


@pytest.mark.parametrize("part", ["project", "moe", "experts_hit"])
def test_moonlight_is_bit_for_bit_as_before(part):
    """The NoPE flag and the held range, both off for Moonlight, leave its
    latent projection, its expert layer and its count of experts hit as
    the code before them computed them."""
    model, cfg = _moonlight()
    assert not cfg.mla_use_nope and cfg.held_experts == range(cfg.n_routed_experts)
    x = torch.randn(24, cfg.hidden_size, generator=torch.Generator().manual_seed(4))
    if part == "project":
        pos = torch.arange(24)
        args = (model.layers[1], cfg, x, model.rope_cos[pos], model.rope_sin[pos])
        for a, b in zip(llm._project(*args), _project_before(*args)):
            assert torch.equal(a, b)
    elif part == "moe":
        for a, b in zip(llm.moe(model.layers[2], cfg, x), _moe_before(model.layers[2], cfg, x)):
            assert torch.equal(a, b)
    else:
        cache = llm.LatentCache(cfg, 2, 16, 3, torch.float32, "cpu")
        cache.routes.copy_(torch.randint(0, cfg.n_routed_experts, cache.routes.shape))
        routes = cache.routes[:, :2, :3].transpose(1, 2).reshape(cache.routes.shape[0], 3, -1)
        before = torch.zeros(*routes.shape[:2], cfg.n_routed_experts,
                             dtype=torch.bool).scatter_(2, routes, True).sum()
        assert cache.experts_hit(2, 3) == int(before)


def test_checkpoint_key_names_load(tiny):
    model, state = tiny
    # a pair iterator loads the same model as the mapping; the conv taps come
    # as [w, 1, 4] and A_log in any shape of H values
    pairs = [(k, v.view(1, 1, -1, 1) if k.endswith("A_log") else v) for k, v in state.items()]
    again = kimi.load_state_dict(kimi.empty_model(model.cfg, torch.float32, "cpu"),
                                 iter(pairs + [("model.layers.1.mlp.experts.99.w", torch.ones(1))]))
    for (name, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name
    layer = model.layers[0]
    w = TINY["linear_attn_config"]["num_heads"] * TINY["linear_attn_config"]["head_dim"]
    assert torch.equal(layer.qkv_fgb[w:2 * w], state["model.layers.0.self_attn.k_proj.weight"])
    assert torch.equal(layer.conv[2 * w:], state["model.layers.0.self_attn.v_conv1d.weight"][:, 0])
    assert [m.kind for m in model.layers] == ["kda", "kda", "kda", "mla"]
    # a card holding experts 4-7 reads those and ignores the others
    half = {**TINY, "num_experts": 4, "num_router_experts": 8, "first_held_expert": 4}
    share = _model(half, state)
    assert torch.equal(share.layers[1].experts_down[0],
                       state["model.layers.1.mlp.experts.4.down_proj.weight"])
    assert share.layers[1].router.shape[0] == 8
    short = dict(state)
    del short["model.layers.3.self_attn.kv_b_proj.weight"]
    with pytest.raises(KeyError, match="kv_b_proj"):
        kimi.load_state_dict(kimi.empty_model(model.cfg, torch.float32, "cpu"), short)


def test_the_hybrid_cache_holds_both_kinds_of_state(tiny):
    model, _ = tiny
    cache = kimi.make_cache(model, 2, 40, 4)
    assert cache.kv.shape == (1, 2, 40, 40)  # the one MLA layer: 32 + 8 a position
    assert cache.state.shape == (3, 2, 4, 16, 16) and cache.state.dtype == torch.float32
    assert cache.conv.shape == (3, 2, 3 * 64, 3)
    assert cache.state_bytes(1) == 3 * (4 * 16 * 16 * 4 + 3 * 64 * 3 * 4)
    kimi.prefill(model, torch.tensor(PROMPTS[0]), [len(PROMPTS[0])], cache)
    assert cache.state[:, 0].abs().sum() > 0 and cache.state[:, 1].abs().sum() == 0
    cache.copy_first_row(1)
    assert torch.equal(cache.state[:, 1], cache.state[:, 0])
    assert torch.equal(cache.conv[:, 1], cache.conv[:, 0])
    cache.reset()
    assert cache.state.abs().sum() == 0 and cache.conv.abs().sum() == 0


def test_the_schedule_and_variants_are_checked():
    cfg = kimi.KimiLinearConfig.from_dict(llm.KIMI_LINEAR_48B_A3B)
    assert cfg.kinds.count("kda") == 20 and cfg.latent_layers == 7
    assert [i + 1 for i, k in enumerate(cfg.kinds) if k == "mla"] == [4, 8, 12, 16, 20, 24, 27]
    assert cfg.router_experts == 256 and cfg.held_experts == range(256)
    assert cfg.context_length == 1048576
    with pytest.raises(ValueError, match="mla_use_nope"):
        kimi.KimiLinearConfig.from_dict({**TINY, "mla_use_nope": False})
    with pytest.raises(ValueError, match="held experts"):
        kimi.KimiLinearConfig.from_dict({**TINY, "num_router_experts": 8, "first_held_expert": 4})


def _transcript(seconds: int) -> list[dict]:
    rows, t = [], 0
    words = ["alpha", "beta", "gamma", "delta", "echo", "fox"]
    while t < seconds * 1000:
        d = 1000 + (t // 700) % 5000
        n = max(1, d * 33 // 10000)
        rows.append({"payload": {"text": " ".join(words[(t // 100 + k) % 6] for k in range(n)),
                                 "start_ms": t, "end_ms": t + d},
                     "span_start_ms": t, "span_end_ms": t + d})
        t += d
    return rows


def test_whole_chapters_through_the_engine(tmp_path):
    """The whole transcript as one prompt, decoded as one row: one row for
    the recording, the spans and counters of the model's prefill."""
    rows = _transcript(60)
    out = InferenceEngine(model_cache_dir=str(tmp_path), device="cpu").run_task(
        "summarization", "talk.mp4", {"model": "kimi-linear-48b-a3b", "segments": rows,
                                      "dims": TINY, "max_new_tokens": 5, "stop_at_eos": False})
    assert len(out) == 1
    p = out[0]["payload"]
    assert (p["start_ms"], p["end_ms"]) == (0, rows[-1]["span_end_ms"])
    assert len(p["token_ids"]) == 5 and all(0 <= t < 512 for t in p["token_ids"])
    task = METRICS.recent_tasks()[-1]
    counters = task["counters"]
    prompt = counters["llm_prompt_tokens"]
    assert prompt > 200 and counters["llm_decode_steps"] == 4 and counters["llm_sections"] == 1
    assert counters["kda_chunks"] == 3 * math.ceil(prompt / kimi.CHUNK)
    assert counters["kda_state_bytes"] == 3 * (4 * 16 * 16 * 4 + 3 * 64 * 3 * 4)
    assert {"llm.prefill", "llm.decode"} <= set(task["spans"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_graph_replays_the_eager_step_bit_for_bit(tiny, card):
    """On the card (bf16, grouped GEMMs over a held share) the decode
    graph's replay over the hybrid cache equals the eager step on the same
    state, and generation through the graph emits what eager decode emits."""
    from eioku_tpu_torch.ml import summarize

    _, state = tiny
    half = {**TINY, "num_experts": 4, "num_router_experts": 8}
    model = _model(half, state, torch.bfloat16, card)
    prompt = PROMPTS[2]
    with kimi.decode_graph(model, 1, 128, 8) as graph:
        cache = graph.buffers
        cache.reset()
        first = kimi.prefill(model, torch.tensor(prompt, device=card), [len(prompt)], cache)
        eager = kimi.make_cache(model, 1, 128, 8)
        for a, b in ((eager.kv, cache.kv), (eager.state, cache.state), (eager.conv, cache.conv),
                     (eager.prompt, cache.prompt)):
            a.copy_(b)
        tokens, pos = first.argmax(-1), torch.tensor([len(prompt)], device=card)
        for _ in range(8):
            want = kimi.decode_step(model, tokens, pos, eager)
            got = kimi.decode_step(model, tokens, pos, cache)
            assert torch.equal(got, want)
            tokens, pos = got.argmax(-1), pos + 1
        assert torch.equal(cache.state, eager.state) and torch.equal(cache.routes, eager.routes)
    # the tiny model's 512 positions cap the length bucket
    with kimi.decode_graph(model, 1, 512, 8):  # held: generation decodes eagerly
        with METRICS.task("summarization"):
            eager_ids = summarize.generate(model, [prompt], 9, False, 1)
    with METRICS.task("summarization"):
        graphed = summarize.generate(model, [prompt], 9, False, 1, 300)
    counters = METRICS.recent_tasks()[-1]["counters"]
    assert counters["llm_decode_graph_replays"] == counters["llm_decode_steps"] == 8
    assert graphed == eager_ids
