"""Moonlight-16B-A3B in the port (`models/llm/`, `ml/summarize.py`) against
its plain float32 reference (`models/llm/reference.py`), at a tiny size on
the CPU: prefill, prefill then decode through the latent cache, the
absorbed decode against the decompressed attention, the routing, the
checkpoint's key names and the `summarization` task through the engine.

The tiny model keeps every mechanism: one dense layer and two expert layers
of 8 experts (top 2, one shared expert), latent attention with a rope part,
a vocabulary with the specials at its top. Parity is held to 1e-4 of the
largest reference logit: float32 on both sides, sums taken in other orders.
"""
from __future__ import annotations

import json
import math

import pytest
import torch

from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.llm import model as llm
from eioku_tpu_torch.models.llm import reference as ref
from eioku_tpu_torch.models.llm.tokenizer import StandInTokenizer
from eioku_tpu_torch.utils.metrics import METRICS

TINY = {**llm.MOONLIGHT_16B_A3B,
        "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "intermediate_size": 128, "moe_intermediate_size": 32, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "n_shared_experts": 1, "first_k_dense_replace": 1,
        "vocab_size": 512, "max_position_embeddings": 256, "bos_token_id": 256,
        "eos_token_id": 257}
RTOL = 1e-4


def seeded_state(cfg: dict, seed: int = 0) -> dict[str, torch.Tensor]:
    """Float32 weights in the checkpoint's names: matrices of std 1/sqrt(in),
    norms near 1, a correction bias of the scores' order, token rows of std 1
    in and 1/sqrt(d) out (logits spread by about 1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.checkpoint_shapes(cfg):
        x = torch.randn(shape, generator=gen)
        if name.endswith("e_score_correction_bias"):
            x = x * 0.1
        elif len(shape) == 1:
            x = 1 + 0.1 * x
        elif name != "model.embed_tokens.weight":
            x = x / math.sqrt(shape[1])
        out[name] = x
    return out


@pytest.fixture(scope="module")
def tiny():
    state = seeded_state(TINY)
    cfg = llm.MoonlightConfig.from_dict(TINY)
    model = llm.load_state_dict(llm.empty_model(cfg, torch.float32, "cpu"), state)
    return model, state


def _close(a: torch.Tensor, b: torch.Tensor) -> None:
    err = float((a - b).abs().max())
    assert err <= RTOL * float(b.abs().max()), err


PROMPTS = [[256, 5, 77, 3, 9, 200, 41, 18, 60, 2, 11], [256, 300, 7, 7, 150],
           [256, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]]


def test_prefill_logits_match_the_reference(tiny):
    model, state = tiny
    cache = llm.LatentCache(model.cfg, len(PROMPTS), 32, 1, torch.float32, "cpu")
    ids = torch.tensor([t for p in PROMPTS for t in p])
    logits = llm.prefill(model, ids, [len(p) for p in PROMPTS], cache)
    for r, p in enumerate(PROMPTS):
        _close(logits[r], ref.forward(state, TINY, p, [len(p) - 1])[0])


def test_decode_through_the_latent_cache_matches_the_full_forward(tiny):
    """Prefill, then 8 steps of every row feeding fixed ids: the logits at
    every emitted position equal the reference's full causal forward over
    prompt plus fed ids."""
    model, state = tiny
    steps = 8
    fed = torch.randint(0, 256, (len(PROMPTS), steps), generator=torch.Generator().manual_seed(1))
    lengths = [len(p) for p in PROMPTS]
    cache = llm.LatentCache(model.cfg, len(PROMPTS), max(lengths) + steps, steps, torch.float32,
                            "cpu")
    got = [llm.prefill(model, torch.tensor([t for p in PROMPTS for t in p]), lengths, cache)]
    pos = torch.tensor(lengths)
    for t in range(steps):
        got.append(llm.decode_step(model, fed[:, t], pos, cache))
        pos = pos + 1
    for r, p in enumerate(PROMPTS):
        seq = p + fed[r].tolist()
        want = ref.forward(state, TINY, seq, list(range(len(p) - 1, len(seq))))
        for t in range(steps + 1):
            _close(got[t][r], want[t])


def test_absorbed_attention_equals_the_decompressed_one(tiny):
    """At one position, attention through the absorbed path over the cache
    equals keys and values decompressed through kv_b_proj."""
    model, _ = tiny
    cfg, layer = model.cfg, model.layers[1]
    gen = torch.Generator().manual_seed(2)
    n = 9
    x = torch.randn(n, cfg.hidden_size, generator=gen)
    pos = torch.arange(n)
    q_nope, q_pe, latent = llm._project(layer, cfg, x, model.rope_cos[pos], model.rope_sin[pos])
    full = llm._attend_decompressed(layer, cfg, q_nope, q_pe, latent, torch.arange(n), 1, n)
    kv = torch.zeros(1, n + 3, cfg.latent_dim)
    kv[0, :n] = latent
    valid = (torch.arange(n + 3) <= n - 1)[None, None]
    last = llm._attend_absorbed(layer, cfg, q_nope[-1:], q_pe[-1:], kv, valid)
    _close(last[0], full[-1])


def test_routing_bias_chooses_and_does_not_weight():
    """A hand-worked case: four experts, top 2. Scores sigmoid(0, 1, 2, -1)
    alone choose experts 2 and 1; a bias of 2 on expert 0 puts it in
    expert 1's place, but the weights are the scores alone, renormalised,
    times the scaling factor."""
    cfg = llm.MoonlightConfig.from_dict({**TINY, "n_routed_experts": 4,
                                         "num_experts_per_tok": 2, "hidden_size": 4})
    layer = llm.MoonlightLayer(cfg, dense=False, dtype=torch.float32)
    with torch.no_grad():
        layer.router.copy_(torch.eye(4))
        layer.router_bias.copy_(torch.tensor([2.0, 0.0, 0.0, 0.0]))
    x = torch.tensor([[0.0, 1.0, 2.0, -1.0]])
    w, chosen = llm.route(layer, cfg, x)
    order = chosen[0].argsort()
    assert chosen[0][order].tolist() == [0, 2]
    s0, s2 = 0.5, 1 / (1 + math.exp(-2))
    want = torch.tensor([s0, s2]) / (s0 + s2) * 2.446
    assert torch.allclose(w[0][order], want, atol=1e-6)
    assert math.isclose(float(w.sum()), 2.446, rel_tol=1e-6)
    # the reference routes alike
    state = {"m.mlp.gate.weight": torch.eye(4),
             "m.mlp.gate.e_score_correction_bias": torch.tensor([2.0, 0.0, 0.0, 0.0])}
    rw, rc = ref.route(x, state, "m.", {**TINY, "num_experts_per_tok": 2})
    assert sorted(rc[0].tolist()) == [0, 2]
    assert torch.allclose(rw.sum(), w.sum())
    with torch.no_grad():
        layer.router_bias.zero_()
    assert sorted(llm.route(layer, cfg, x)[1][0].tolist()) == [1, 2]


def test_moe_layer_matches_the_per_expert_loop(tiny):
    """The sorted, grouped expert layer equals the reference's loop over
    experts, and counts the experts it gave tokens to."""
    model, state = tiny
    cfg = model.cfg
    x = torch.randn(20, cfg.hidden_size, generator=torch.Generator().manual_seed(3))
    got, chosen, ends = llm.moe(model.layers[2], cfg, x)
    _close(got, ref.moe(x, state, "model.layers.2.", TINY))
    assert torch.equal(chosen, llm.route(model.layers[2], cfg, x)[1])
    assert int(llm._groups_hit(ends)) == len(set(chosen.flatten().tolist()))
    assert int(ends[-1]) == 20 * TINY["num_experts_per_tok"]


def test_padding_rows_copy_the_first_and_the_route_log(tiny):
    """Rows that pad a batch to a graph's width compute what row 0 does and
    route to its experts; each decode step logs every row's experts, and
    the experts hit count each layer-step's distinct experts once."""
    model, _ = tiny
    cfg = model.cfg
    prompts = PROMPTS[:2]
    lengths = [len(p) for p in prompts]
    steps, width = 3, 4
    cache = llm.LatentCache(cfg, width, max(lengths) + steps, steps, torch.float32, "cpu")
    logits = llm.prefill(model, torch.tensor(prompts[0] + prompts[1]), lengths, cache)
    cache.copy_first_row(2)
    tokens = torch.cat([logits.argmax(-1), logits[:1].argmax(-1).repeat(2)])
    pos = torch.tensor(lengths + lengths[:1] * 2)
    for _ in range(steps):
        out = llm.decode_step(model, tokens, pos, cache)
        assert torch.equal(out[2], out[0]) and torch.equal(out[3], out[0])
        tokens, pos = out.argmax(-1), pos + 1
    assert torch.equal(cache.routes[:, 2], cache.routes[:, 0])
    moe_layers, k = cfg.num_hidden_layers - 1, cfg.num_experts_per_tok
    assert cache.routes.shape == (moe_layers, width, steps, k)
    distinct = sum(len(set(cache.routes[j, :2, t].flatten().tolist()))
                   for j in range(moe_layers) for t in range(steps))
    assert cache.experts_hit(2, steps) == int(cache.prefill_hits) + distinct
    assert cache.experts_hit(4, steps) == cache.experts_hit(2, steps)  # copies add none


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_graph_replays_the_eager_step_bit_for_bit(tiny, card):
    """On the card (bf16, grouped GEMMs) the decode graph's replay equals the
    eager step on the same cache state, and generation through the graph
    emits what the eager decode emits."""
    from eioku_tpu_torch.ml import summarize

    _, state = tiny
    model = llm.load_state_dict(llm.empty_model(llm.MoonlightConfig.from_dict(TINY),
                                                torch.bfloat16, card), state)
    lengths = [len(p) for p in PROMPTS]
    ids = torch.tensor([t for p in PROMPTS for t in p], device=card)
    with llm.decode_graph(model, 4, 64, 8) as graph:
        cache = graph.buffers
        cache.reset()
        first = llm.prefill(model, ids, lengths, cache)
        cache.copy_first_row(3)
        tokens = torch.cat([first.argmax(-1), first[:1].argmax(-1)])
        pos = torch.tensor(lengths + lengths[:1], device=card)
        eager = llm.LatentCache(model.cfg, 4, 64, 8, torch.bfloat16, card)
        eager.kv.copy_(cache.kv)
        eager.prompt.copy_(cache.prompt)
        for _ in range(8):
            want = llm.decode_step(model, tokens, pos, eager)
            got = llm.decode_step(model, tokens, pos, cache)
            assert torch.equal(got, want)
            tokens, pos = got.argmax(-1), pos + 1
        assert torch.equal(cache.routes, eager.routes)
    # the tiny model's 256 positions cap the length bucket
    with llm.decode_graph(model, 4, 256, 8):  # held: generation decodes eagerly
        with METRICS.task("summarization"):
            eager_ids = summarize.generate(model, PROMPTS, 9, False, 4)
    assert "llm_decode_graph_replays" not in METRICS.recent_tasks()[-1]["counters"]
    with METRICS.task("summarization"):
        graphed = summarize.generate(model, PROMPTS, 9, False, 4)
    counters = METRICS.recent_tasks()[-1]["counters"]
    assert counters["llm_decode_graph_replays"] == counters["llm_decode_steps"] == 8
    assert counters["llm_decode_graph_captures"] == 1  # captured at its first replay
    assert len(graphed) == 3 and all(len(r) == 9 for r in graphed)
    assert graphed == eager_ids


@pytest.mark.cuda
def test_a_held_graph_outlives_four_other_shapes(tiny, card):
    """A generation's graph is never dropped while held, however many other
    shapes are made meanwhile: the next generation of its shape replays it
    with no new capture and emits what the first did."""
    from eioku_tpu_torch.ml import summarize

    _, state = tiny
    model = llm.load_state_dict(llm.empty_model(llm.MoonlightConfig.from_dict(TINY),
                                                torch.bfloat16, card), state)
    first = summarize.generate(model, PROMPTS, 9, False, 4)  # captures (4, 256, 8)
    with llm.decode_graph(model, 4, 256, 8) as held:
        for steps in range(1, 5):
            with llm.decode_graph(model, 4, 256, steps) as other:
                assert held is not None and other is not None and other is not held
    with METRICS.task("summarization"):
        again = summarize.generate(model, PROMPTS, 9, False, 4)
    counters = METRICS.recent_tasks()[-1]["counters"]
    assert counters["llm_decode_graph_replays"] == counters["llm_decode_steps"] == 8
    assert "llm_decode_graph_captures" not in counters
    assert again == first


def test_checkpoint_key_names_load(tiny):
    model, state = tiny
    # a pair iterator (as shards are read) loads the same model as the mapping
    again = llm.load_state_dict(llm.empty_model(model.cfg, torch.float32, "cpu"),
                                iter(list(state.items()) + [("rotary.inv_freq", torch.ones(1))]))
    for (name, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name
    # head 0's q_pe rows follow every q_nope row and c_kv's, read in the
    # published interleaved order
    nope, rope, h = TINY["qk_nope_head_dim"], TINY["qk_rope_head_dim"], TINY["num_attention_heads"]
    pe = h * nope + TINY["kv_lora_rank"]
    q = state["model.layers.0.self_attn.q_proj.weight"]
    assert torch.equal(model.layers[0].qkv_a[:nope], q[:nope])
    assert torch.equal(model.layers[0].qkv_a[pe:pe + rope], q[nope:nope + rope][
        torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)])])
    assert torch.equal(model.layers[1].experts_down[5],
                       state["model.layers.1.mlp.experts.5.down_proj.weight"])
    short = dict(state)
    del short["model.layers.2.mlp.experts.7.up_proj.weight"]
    with pytest.raises(KeyError, match="experts.7.up_proj"):
        llm.load_state_dict(llm.empty_model(model.cfg, torch.float32, "cpu"), short)


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


def test_sections_are_near_equal_and_within_the_limit():
    from eioku_tpu_torch.ml.summarize import split_sections

    tok = StandInTokenizer(163840, 163584, 163585)
    rows = _transcript(600)
    sections = split_sections(rows, tok, 300)
    total = sum(s["tokens"] for s in sections)
    assert len(sections) == math.ceil(total / 300)
    assert all(s["tokens"] <= 300 for s in sections)
    assert max(s["tokens"] for s in sections) - min(s["tokens"] for s in sections) < 40
    assert sections[0]["text"].startswith("[00:00] ")
    assert [s["start_ms"] for s in sections[1:]] == [s["end_ms"] for s in sections[:-1]]
    assert split_sections([], tok, 300) == []


@pytest.mark.parametrize("decode_rows", [8, 2])
def test_summarization_through_the_engine(tmp_path, monkeypatch, decode_rows):
    """One batch of every section, or (2 rows a batch) several batches."""
    from eioku_tpu_torch.ml import summarize
    from eioku_tpu_torch.ml.summarize import split_sections

    monkeypatch.setattr(summarize, "DECODE_ROWS", decode_rows)
    rows = _transcript(300)
    out = InferenceEngine(model_cache_dir=str(tmp_path), device="cpu").run_task(
        "summarization", "talk.mp4", {"segments": rows, "dims": TINY, "section_tokens": 200,
                                      "max_new_tokens": 5, "stop_at_eos": False})
    tok = StandInTokenizer(512, 256, 257)
    assert len(out) == len(split_sections(rows, tok, 200)) >= 5
    # 4 decode steps a batch of at most DECODE_ROWS sections
    counters = METRICS.recent_tasks()[-1]["counters"]
    assert counters["llm_decode_steps"] == 4 * math.ceil(len(out) / decode_rows)
    assert out[0]["span_start_ms"] == 0 and out[-1]["span_end_ms"] == rows[-1]["span_end_ms"]
    assert [r["span_start_ms"] for r in out[1:]] == [r["span_end_ms"] for r in out[:-1]]
    for r in out:
        p = r["payload"]
        assert (p["start_ms"], p["end_ms"]) == (r["span_start_ms"], r["span_end_ms"])
        assert len(p["token_ids"]) == 5 and all(0 <= t < 512 for t in p["token_ids"])
        assert isinstance(p["text"], str)


def test_rows_stop_at_eos(tiny):
    """With an lm_head that makes EOS every row's best token, generation
    stops at its first check and cuts each row before its EOS."""
    from eioku_tpu_torch.ml import summarize

    model, state = tiny
    eos_first = dict(state)
    head = state["lm_head.weight"].clone()
    head[TINY["eos_token_id"]] = 50 * head.abs().max()
    eos_first["lm_head.weight"] = head
    eos_model = llm.load_state_dict(llm.empty_model(model.cfg, torch.float32, "cpu"), eos_first)
    with METRICS.task("summarization"):
        out = summarize.generate(eos_model, PROMPTS, 40, True)
    assert out == [[], [], []]
    assert METRICS.recent_tasks()[-1]["counters"]["llm_decode_steps"] == \
        summarize.EOS_CHECK_STEPS


def test_safetensors_shards_load_through_the_task(tiny, tmp_path):
    """A directory of safetensors shards in the checkpoint's key names, as
    the model is published, loads through the task's cache lookup."""
    from safetensors.torch import save_file

    from eioku_tpu_torch.ml import summarize

    model, state = tiny
    names = sorted(state)
    folder = tmp_path / "moonlight-16b-a3b"
    folder.mkdir()
    for i, part in enumerate((names[:len(names) // 2], names[len(names) // 2:])):
        save_file({k: state[k].contiguous() for k in part}, str(folder / f"model-{i}.safetensors"))
    summarize._load_model.cache_clear()
    try:
        loaded = summarize._load_model("moonlight-16b-a3b", json.dumps(TINY, sort_keys=True),
                                       str(tmp_path), "float32", torch.device("cpu"))
    finally:
        summarize._load_model.cache_clear()
    for (name, a), b in zip(model.named_parameters(), loaded.parameters()):
        assert torch.equal(a, b), name
