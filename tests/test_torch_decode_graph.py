"""The Whisper decoder step as one CUDA graph (models/whisper/model.py
`decoder_step`, `DecodeBuffers`, `step_graph`; decoding.py `reorder_beams`).

On the CPU: `decoder_step`, whose self-attention runs over the whole cache
with the tail masked, run in fp32 over caches longer than the tokens (as a
graph's rounded buffers are) against attention over the live prefix alone,
over prefill and beam steps with beam reorders between them; the in-place
reorder over the live prefix against the out-of-place `index_select` of the
whole buffers; no graph on the CPU. The tests marked `cuda` run on an
NVIDIA GPU (skipped elsewhere): the graphed step against the same step
run eagerly in bf16, whole decodes, one capture per shape, a graph in use
kept from a second decode, foreign buffers, the TP and int8 decodes,
which stay eager, and every graphed and int8 step's attention through the
decode attention kernel (ops/decode_attention.py) and its residual adds
and LayerNorms through the add-and-LayerNorm kernel (ops/add_layer_norm.py).
This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_decode_graph.py -q
"""
import pytest
import torch

from eioku_tpu_torch.models import layers
from eioku_tpu_torch.models.whisper import decoding, model
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens
from eioku_tpu_torch.ops.decode_attention import decode_attention_plain
from eioku_tpu_torch.parallel import mesh
from eioku_tpu_torch.utils.metrics import METRICS

TINY = model.WhisperConfig("tiny")
TINY_BF16 = model.WhisperConfig("tiny", compute_dtype="bfloat16")


def _whisper(cfg: model.WhisperConfig, device: str = "cpu") -> model.Whisper:
    """Seeded random weights in the configuration's type, the token
    embedding scaled by 50 so that the logits tell tokens apart (random
    ones put every token within ~1e-3 of every other)."""
    m = model.init_whisper(cfg, torch.Generator().manual_seed(0))
    m.decoder.token_embedding.weight.data.mul_(50.0)
    return m.to(device=device, dtype=cfg.dtype).eval()


@pytest.fixture(scope="module")
def tiny():
    return _whisper(TINY)


def _enc(windows: int, cfg: model.WhisperConfig, device: str = "cpu", seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((windows, model.N_AUDIO_CTX, cfg.dim), generator=g).to(device, cfg.dtype)


def _beam_sources(windows: int, beams: int, g: torch.Generator) -> torch.Tensor:
    """A beam search's row sources: each row takes a beam of its own window."""
    picks = torch.randint(0, beams, (windows, beams), generator=g)
    return (torch.arange(windows)[:, None] * beams + picks).reshape(-1)


# -- on the CPU ----------------------------------------------------------------------------


@torch.no_grad()
def _prefix_step(m, cross_k, cross_v, tokens, self_k, self_v, pos: int):
    """The step with self-attention over positions 0..pos of the caches
    alone, no mask, and each residual add and LayerNorm an operation of its
    own."""
    cfg, dec = m.cfg, m.decoder
    x = (dec.token_embedding.weight[tokens[:, pos]][:, None, :]
         + dec.positional_embedding[pos][None, None]).to(cfg.dtype)
    for li, block in enumerate(dec.blocks):
        h = block.attn_ln(x)
        at = block.attn
        self_k[li, :, pos] = at.key(h)[:, 0]
        self_v[li, :, pos] = at.value(h)[:, 0]
        attn = model._attend(at.query(h), self_k[li, :, :pos + 1], self_v[li, :, :pos + 1],
                             cfg.n_heads)
        x = x + at.out(attn)
        ca = block.cross_attn
        x = x + ca.out(decode_attention_plain(ca.query(block.cross_attn_ln(x)), cross_k[li],
                                              cross_v[li], cfg.n_heads))
        x = x + model._mlp(block.mlp_ln(x), block)
    return model._logits(m, dec.ln(x)[:, 0])


@pytest.mark.parametrize("grouped", [False, True], ids=["rows", "grouped"])
def test_static_step_matches_the_step(tiny, grouped):
    """Prefill (positions 0-2) and beam steps (3-9, reordered after each),
    the masked step over caches of 16 positions and the first 12 columns of
    a tokens buffer of 16: logits within 2e-5 of the prefix step's (the same
    fp32 products, the softmax summed over the masked tail's exact zeros),
    caches alike."""
    windows, beams, max_len, n = 2, 3, 12, 16
    rows = windows * beams
    g = torch.Generator().manual_seed(2)
    cross_k, cross_v = model.precompute_cross_kv(tiny, _enc(windows, TINY))
    if not grouped:  # one cross row per token row
        cross_k, cross_v = (c.repeat_interleave(beams, 1) for c in (cross_k, cross_v))
    tokens = torch.randint(0, TINY.vocab_size, (rows, max_len), generator=g)
    shape = (TINY.n_dec_layers, rows, max_len, TINY.dim)
    prefix = [tokens.clone(), torch.zeros(shape), torch.zeros(shape)]
    buf = torch.full((rows, n), -1)
    buf[:, :max_len] = tokens
    static = [buf[:, :max_len], torch.zeros(shape[:2] + (n, TINY.dim)),
              torch.zeros(shape[:2] + (n, TINY.dim))]
    for pos in range(max_len - 2):
        want = _prefix_step(tiny, cross_k, cross_v, *prefix, pos)
        got = model.decoder_step(tiny, cross_k, cross_v, *static, pos)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        for c in (1, 2):
            torch.testing.assert_close(static[c][:, :, :max_len], prefix[c], rtol=0, atol=2e-5)
            assert not static[c][:, :, max_len:].any()
        if pos >= 3:  # past the prompt: beams reorder
            src = _beam_sources(windows, beams, g)
            for t, k, v in (prefix, static):
                decoding.reorder_beams(t, k, v, src, pos + 1)
            assert torch.equal(static[0], prefix[0])


@pytest.mark.parametrize("shards", [1, 2], ids=["one-cache", "per-shard-caches"])
@pytest.mark.parametrize("live", [1, 5, 16])
def test_prefix_reorder_is_in_place_and_equals_index_select(shards, live):
    """Beyond the live prefix the tokens are EOT and the caches zero, as in
    a decode: the reorder over the prefix equals the whole buffers'
    out-of-place index_select, and every buffer keeps its address."""
    windows, beams, max_len, eot = 3, 4, 16, 50257
    rows = windows * beams
    g = torch.Generator().manual_seed(live)
    tokens = torch.full((rows, max_len), eot)
    tokens[:, :live] = torch.randint(0, eot, (rows, live), generator=g)

    def cache():
        c = torch.zeros((2, rows, max_len, 8))
        c[:, :, :live] = torch.randn((2, rows, live, 8), generator=g)
        return c
    self_k = [cache() for _ in range(shards)]
    self_v = [cache() for _ in range(shards)]
    if shards == 1:
        self_k, self_v = self_k[0], self_v[0]
    src = _beam_sources(windows, beams, g)
    each = (lambda x: x) if shards > 1 else (lambda x: [x])
    want = ([tokens.index_select(0, src)], [c.index_select(1, src) for c in each(self_k)],
            [c.index_select(1, src) for c in each(self_v)])
    ptrs = [t.data_ptr() for t in [tokens, *each(self_k), *each(self_v)]]
    decoding.reorder_beams(tokens, self_k, self_v, src, live)
    assert [t.data_ptr() for t in [tokens, *each(self_k), *each(self_v)]] == ptrs
    assert torch.equal(tokens, want[0][0])
    for got, exp in zip([*each(self_k), *each(self_v)], want[1] + want[2]):
        assert torch.equal(got, exp)


def test_no_graph_on_the_cpu(tiny):
    tk = WhisperTokens(TINY.vocab_size)
    enc = _enc(2, TINY)
    init = torch.tensor([tk.sot_sequence("en")] * 2)
    sa, sb = decoding.build_suppress_masks(tk, timestamps=True)
    with model.step_graph(tiny, enc, 6, 12) as graph:
        assert graph is None
    with METRICS.task("transcription"):
        decoding.whisper_decode_windows(tiny, enc, init, sa, sb, max_len=12, beam_size=3)
    counters = METRICS.recent_tasks()[-1]["counters"]
    assert counters["decode_steps"] > 0
    assert counters["decode_graph_replays"] == 0 and "decode_graph_captures" not in counters


# -- on the card ----------------------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture only on the card "
                    "(the graphed body runs eagerly on the CPU above)")
    return "cuda"


@pytest.fixture()
def tiny_bf16(card):
    return _whisper(TINY_BF16, card)


def _last_counters(fn) -> dict:
    with METRICS.task("transcription"):
        fn()
    return METRICS.recent_tasks()[-1]["counters"]


def _decode(m, enc, beams, max_len=24, **kw):
    tk = WhisperTokens(m.cfg.vocab_size)
    init = torch.tensor([tk.sot_sequence("en")] * enc.shape[0])
    sa, sb = decoding.build_suppress_masks(tk, timestamps=True)
    return decoding.whisper_decode_windows(m, enc, init, sa, sb, max_len=max_len,
                                           beam_size=beams, **kw)


def _filled_graph(m, graph, enc, seed: int):
    """The graph's buffers with the encoder's cross K/V and random tokens."""
    b = graph.buffers
    tokens, self_k, self_v, cross_k, cross_v = b.tokens, b.self_k, b.self_v, b.cross_k, b.cross_v
    model.precompute_cross_kv(m, enc, out=(cross_k, cross_v))
    tokens.copy_(torch.randint(0, m.cfg.vocab_size, tokens.shape,
                               generator=torch.Generator().manual_seed(seed)))
    self_k.zero_()
    self_v.zero_()
    return tokens, self_k, self_v, cross_k, cross_v


@pytest.mark.cuda
def test_graphed_step_matches_the_eager_step(tiny_bf16, card):
    """bf16: the replay runs the kernels that the eager call of the same
    body on buffers of the same shapes launches, so the logits and caches
    are equal bit for bit."""
    windows, beams, max_len = 2, 5, 16
    enc = _enc(windows, TINY_BF16, card)
    with model.step_graph(tiny_bf16, enc, windows * beams, max_len) as graph:
        tokens, self_k, self_v, cross_k, cross_v = _filled_graph(tiny_bf16, graph, enc, 3)
        eager = [t.clone() for t in (tokens, self_k, self_v)]
        for pos in range(max_len - 1):
            got = model.decoder_step(tiny_bf16, cross_k, cross_v, tokens, self_k, self_v, pos)
            want = model.decoder_step(tiny_bf16, cross_k.clone(), cross_v.clone(), *eager, pos)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(self_k, eager[1], rtol=0, atol=0)
        torch.testing.assert_close(self_v, eager[2], rtol=0, atol=0)
        assert graph.graph is not None
        assert graph.buffers.attn_kernel and graph.buffers.norm_kernel  # K4, K5 in the graph


@pytest.mark.cuda
@pytest.mark.parametrize("max_len", [24, 32])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_graphed_decode_emits_the_eager_tokens(tiny_bf16, card, seed, max_len):
    """The same tokens and average logprobs graphed as eager. At 24 the
    graph's caches are rounded up to 32 positions; the attention kernel
    reads only the live prefix, so their length does not enter."""
    enc = _enc(4, TINY_BF16, card, seed)
    graphed = _decode(tiny_bf16, enc, 5, max_len)
    eager = _decode(tiny_bf16, enc, 5, max_len, step_fn=model.decoder_step)
    assert torch.equal(graphed[0], eager[0])
    torch.testing.assert_close(graphed[1], eager[1], rtol=0, atol=0)
    torch.testing.assert_close(graphed[2], eager[2], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [(24, 24), (24, 30)], ids=["one-length", "one-rounded-length"])
def test_one_shape_captures_once(tiny_bf16, card, lengths):
    first = _last_counters(lambda: _decode(tiny_bf16, _enc(2, TINY_BF16, card, 4), 5, lengths[0]))
    second = _last_counters(lambda: _decode(tiny_bf16, _enc(2, TINY_BF16, card, 5), 5, lengths[1]))
    assert first["decode_graph_captures"] == 1 and "decode_graph_captures" not in second
    for c in (first, second):
        assert c["decode_graph_replays"] == c["decode_steps"] > 0


@pytest.mark.cuda
def test_a_graph_in_use_is_not_shared(tiny_bf16, card):
    """A second decode of the shape while the first holds its graph runs
    eagerly on buffers of its own; the graph is handed out again after."""
    enc = _enc(2, TINY_BF16, card)
    with model.step_graph(tiny_bf16, enc, 10, 16) as first:
        with model.step_graph(tiny_bf16, enc, 10, 16) as second:
            assert first is not None and second is None
    with model.step_graph(tiny_bf16, enc, 10, 16) as again:
        assert again is first


@pytest.mark.cuda
def test_foreign_caches_are_written_not_the_graphs(tiny_bf16, card):
    """The benchmark's stale_state fault: clones of the graph's caches get
    this step's keys and values; the graph's own caches stay as they were."""
    windows, beams, max_len = 2, 5, 16
    enc = _enc(windows, TINY_BF16, card)
    with model.step_graph(tiny_bf16, enc, windows * beams, max_len) as graph:
        tokens, self_k, self_v, cross_k, cross_v = _filled_graph(tiny_bf16, graph, enc, 7)
        k2, v2 = self_k.clone(), self_v.clone()
        replays = _last_counters(lambda: model.decoder_step(
            tiny_bf16, cross_k, cross_v, tokens, k2, v2, 0)).get("decode_graph_replays", 0)
        assert replays == 0
        assert k2[:, :, 0].abs().sum() > 0 and v2[:, :, 0].abs().sum() > 0
        assert self_k.abs().sum() == 0 and self_v.abs().sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tensor-parallel", "int8"])
def test_tensor_parallel_and_int8_stay_eager(tiny_bf16, card, path, monkeypatch):
    enc = _enc(2, TINY_BF16, card, 6)
    if path == "int8":
        m = layers.quantize_linears(_whisper(TINY_BF16, card))
        run = lambda: _decode(m, enc, 5)  # noqa: E731
    else:
        monkeypatch.setattr(mesh, "local_devices", lambda device=None: [torch.device(card, 0)] * 2)
        tk = WhisperTokens(TINY.vocab_size)
        init = torch.tensor([tk.sot_sequence("en")] * 2)
        sa, sb = decoding.build_suppress_masks(tk, timestamps=True)
        run = lambda: decoding.whisper_decode_windows_tp(  # noqa: E731
            tiny_bf16, enc, init, sa, sb, mesh=mesh.make_mesh(2, model_parallel=2),
            max_len=24, beam_size=5)
    counters = _last_counters(run)
    assert counters["decode_steps"] > 0 and counters["decode_graph_replays"] == 0
    assert "decode_graph_captures" not in counters


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["graphed", "int8"])
def test_every_step_takes_the_attention_kernel(tiny_bf16, card, path):
    """decode_attn_kernel_pct, `decode_attn_kernel_steps` / `decode_steps`
    x 100, reads 100: every replay of a graph captured with the kernel, and
    every eager step of the int8 decoder, which launches it."""
    enc = _enc(2, TINY_BF16, card, 8)
    m = tiny_bf16 if path == "graphed" else layers.quantize_linears(_whisper(TINY_BF16, card))
    counters = _last_counters(lambda: _decode(m, enc, 5))
    assert counters["decode_steps"] > 0
    assert counters["decode_attn_kernel_steps"] / counters["decode_steps"] * 100 == 100
    replays = counters["decode_steps"] if path == "graphed" else 0
    assert counters["decode_graph_replays"] == replays


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["graphed", "int8"])
def test_every_step_takes_the_norm_kernel(tiny_bf16, card, path):
    """decode_norm_kernel_pct, `decode_norm_kernel_steps` / `decode_steps`
    x 100, reads 100: every replay of a graph captured with the
    add-and-LayerNorm kernel, and every eager step of the int8 decoder,
    which launches it."""
    enc = _enc(2, TINY_BF16, card, 9)
    m = tiny_bf16 if path == "graphed" else layers.quantize_linears(_whisper(TINY_BF16, card))
    counters = _last_counters(lambda: _decode(m, enc, 5))
    assert counters["decode_steps"] > 0
    assert counters["decode_norm_kernel_steps"] / counters["decode_steps"] * 100 == 100
    replays = counters["decode_steps"] if path == "graphed" else 0
    assert counters["decode_graph_replays"] == replays
