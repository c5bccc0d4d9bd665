"""The one holder of the decoders' CUDA graphs (models/step_graphs.py) on
the CPU: the table's rules, with buffers that are never captured, and both
decoders' graphed steps through a stand-in for the capture that runs the
step's body eagerly. The capture itself runs on the card, in the `cuda`
tests of test_torch_decode_graph.py and test_torch_llm.py."""
import contextlib

import pytest
import torch
from torch import nn

from eioku_tpu_torch.models import step_graphs
from eioku_tpu_torch.models.llm import model as llm
from eioku_tpu_torch.models.whisper import decoding
from eioku_tpu_torch.models.whisper import model as whisper
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens
from eioku_tpu_torch.utils.metrics import METRICS


def _never_run(model, buffers):
    raise AssertionError("the table's tests capture nothing")


def _lend(model, key):
    """The model's graph of `key`, whose buffers name the key."""
    return step_graphs.hand_out(model, key, lambda: {"key": key}, _never_run, "")


def _kept(model, key) -> bool:
    return step_graphs.holding(model, lambda b: b["key"] == key) is not None


@pytest.mark.parametrize("others", [1, 3])
def test_a_held_shape_goes_to_one_decode_at_a_time(others):
    """While a decode holds a shape, every other decode of it gets None (and
    runs eagerly), another shape is free, and once released the same graph
    is handed out again."""
    model = nn.Linear(2, 2)
    with _lend(model, "a") as first:
        for _ in range(others):
            with _lend(model, "a") as second:
                assert first is not None and second is None
        with _lend(model, "b") as other:
            assert other is not None and other is not first
    with _lend(model, "a") as again:
        assert again is first


@pytest.mark.parametrize("held", [(), (0,), (0, 1), (0, 1, 2, 3)], ids=str)
def test_the_least_recently_used_idle_shape_goes(held):
    """Shapes 0-3 made in turn, shapes `held` still held, then shape 4: the
    table keeps KEPT shapes by dropping the oldest idle one, never a held
    one (with all held it keeps them all)."""
    assert step_graphs.KEPT == 4
    model = nn.Linear(2, 2)
    with contextlib.ExitStack() as holders:
        for key in range(4):
            with _lend(model, key):
                pass
            if key in held:
                holders.enter_context(_lend(model, key))
        with _lend(model, 4):
            pass
        idle = [k for k in range(4) if k not in held]
        dropped = idle[:1]
        assert [k for k in range(5) if _kept(model, k)] == [k for k in range(5) if k not in dropped]


@pytest.mark.parametrize("change", ["none", "in-place", "weight", "bias"])
def test_moved_parameters_make_a_new_graph(change):
    """A parameter at a new address (a reload into new tensors) makes the
    shape anew; values copied into the old ones (the loaders' way) keep it."""
    model = nn.Linear(2, 2)
    with _lend(model, "a") as first:
        pass
    if change == "in-place":
        with torch.no_grad():
            model.weight.mul_(2)
    elif change != "none":
        setattr(model, change, nn.Parameter(getattr(model, change).detach().clone()))
    with _lend(model, "a") as again:
        assert (again is first) == (change in ("none", "in-place"))


class _StandIn:
    """A CUDA graph's stand-in on the CPU: a replay runs the body again,
    into the logits of the captured call."""

    def __init__(self, step: step_graphs.CapturedStep, model):
        self.step, self.model = step, model

    def replay(self):
        self.step.logits.copy_(self.step.body(self.model, self.step.buffers))


def _capture_eagerly(self, model):
    self._warm_up(model)
    # a capture runs nothing: what this run carries forward is undone
    carried = getattr(self.buffers, "carried", ())
    before = [t.clone() for t in carried]
    self.logits = self.body(model, self.buffers)
    for t, b in zip(carried, before):
        t.copy_(b)
    return _StandIn(self, model)


def _cpu_step_graph(model, enc_out, rows, max_len):
    """Whisper's `step_graph` without its off-card refusal."""
    return step_graphs.hand_out(
        model, (rows, max_len), lambda: whisper.decode_buffers(model, enc_out, rows, max_len),
        whisper._decoder_step_static, "")


def _whisper_decode(monkeypatch, graphed: bool):
    """A beam decode of tiny Whisper, in a graph's buffers or eagerly: (its
    outputs, its decoder steps)."""
    m = whisper.init_whisper(whisper.WhisperConfig("tiny"), torch.Generator().manual_seed(0))
    m.decoder.token_embedding.weight.data.mul_(50.0)  # logits that tell tokens apart
    enc = torch.randn((1, whisper.N_AUDIO_CTX, m.cfg.dim),
                      generator=torch.Generator().manual_seed(1))
    tk = WhisperTokens(m.cfg.vocab_size)
    sa, sb = decoding.build_suppress_masks(tk, timestamps=True)
    steps = []

    def counted(*args):
        steps.append(args[-1])
        return whisper.decoder_step(*args)
    monkeypatch.setattr(decoding, "decoder_step", counted)
    monkeypatch.setattr(decoding, "step_graph", _cpu_step_graph if graphed else whisper.step_graph)
    out = decoding.whisper_decode_windows(m, enc, torch.tensor([tk.sot_sequence("en")]), sa, sb,
                                          max_len=12, beam_size=3)
    return list(out), len(steps)


MOONLIGHT = {**llm.MOONLIGHT_16B_A3B,
             "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
             "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
             "v_head_dim": 16, "intermediate_size": 128, "moe_intermediate_size": 32,
             "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
             "vocab_size": 512, "max_position_embeddings": 64, "bos_token_id": 256,
             "eos_token_id": 257}


def _moonlight_decode(monkeypatch, graphed: bool):
    """Greedy steps of a tiny Moonlight on a graph's LatentCache or a cache
    of its own: (the logits and the route log, the decode steps)."""
    model = llm.init_random(llm.MoonlightConfig.from_dict(MOONLIGHT), torch.float32, "cpu")
    prompts, steps = [[256, 5, 77, 3, 9], [256, 300, 7]], 6
    lengths = [len(p) for p in prompts]
    with (llm.decode_graph(model, 2, 16, steps) if graphed
          else contextlib.nullcontext()) as graph:
        cache = (graph.buffers if graphed
                 else llm.LatentCache(model.cfg, 2, 16, steps, torch.float32, "cpu"))
        cache.reset()
        out = [llm.prefill(model, torch.tensor(prompts[0] + prompts[1]), lengths, cache)]
        tokens, pos = out[0].argmax(-1), torch.tensor(lengths)
        for _ in range(steps):
            out.append(llm.decode_step(model, tokens, pos, cache))
            tokens, pos = out[-1].argmax(-1), pos + 1
    return out + [cache.kv, cache.routes], steps


KIMI = {**llm.KIMI_LINEAR_48B_A3B,
        "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "intermediate_size": 128, "moe_intermediate_size": 32, "num_experts": 4,
        "num_router_experts": 8, "num_experts_per_token": 2, "vocab_size": 512,
        "model_max_length": 64, "bos_token_id": 256, "eos_token_id": 257,
        "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3], "head_dim": 16,
                               "num_heads": 4, "short_conv_kernel_size": 4}}


def _kimi_decode(monkeypatch, graphed: bool):
    """Greedy steps of a tiny Kimi-Linear (a recurrent state the step
    carries forward) on a graph's HybridCache or a cache of its own."""
    from eioku_tpu_torch.models.llm import kimi_linear as kimi

    model = kimi.init_random(kimi.KimiLinearConfig.from_dict(KIMI), torch.float32, "cpu")
    with torch.no_grad():
        model.lm_head.mul_(50.0)  # logits that tell tokens apart
    prompt, steps = [256, 5, 77, 3, 9, 41, 2], 6
    with (kimi.decode_graph(model, 1, 16, steps) if graphed
          else contextlib.nullcontext()) as graph:
        cache = graph.buffers if graphed else kimi.make_cache(model, 1, 16, steps)
        cache.reset()
        out = [kimi.prefill(model, torch.tensor(prompt), [len(prompt)], cache)]
        tokens, pos = out[0].argmax(-1), torch.tensor([len(prompt)])
        for _ in range(steps):
            out.append(kimi.decode_step(model, tokens, pos, cache))
            tokens, pos = out[-1].argmax(-1), pos + 1
    return out + [cache.kv, cache.state, cache.conv, cache.routes], steps


@pytest.mark.parametrize("decode, prefix", [(_whisper_decode, ""), (_moonlight_decode, "llm_"),
                                            (_kimi_decode, "llm_")],
                         ids=["whisper", "moonlight", "kimi-linear"])
def test_graphed_steps_replay_the_eager_ones(decode, prefix, monkeypatch):
    """Through the stand-in capture, each decoder's graphed steps give what
    its eager steps give (its inputs written into the buffers before each
    replay; a recurrent state advanced once a step, the capture's warm-up
    undone); the graph is captured at its first replay and counted under
    the decoder's prefix: `decode_graph_*` for Whisper, `llm_decode_graph_*`
    for the language models, the names the benchmark's readers take."""
    monkeypatch.setattr(step_graphs.CapturedStep, "_capture", _capture_eagerly)
    with METRICS.task("decode"):
        graphed, steps = decode(monkeypatch, True)
    counters = METRICS.recent_tasks()[-1]["counters"]
    eager, eager_steps = decode(monkeypatch, False)
    assert steps == eager_steps > 0
    assert len(graphed) == len(eager) and all(torch.equal(g, e) for g, e in zip(graphed, eager))
    assert counters[prefix + "decode_graph_captures"] == 1
    assert counters[prefix + "decode_graph_replays"] == steps
    assert not any(k.startswith("llm_" if prefix == "" else "decode_graph") for k in counters)
