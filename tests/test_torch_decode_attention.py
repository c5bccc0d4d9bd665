"""Decoder attention for one query position (ops/decode_attention.py, the
kernel csrc/decode_attention.cu).

On the CPU: the plain version against the Whisper decoder's plain attention
(models/whisper/model.py `_attend` with the live mask) and its grouped
cross-attention as it stood before the op, exactly in fp32; the CPU step
takes the plain version and counts no kernel step. The tests marked `cuda` run on an NVIDIA GPU (skipped elsewhere): the
kernel against the plain version at the batched transcription's shapes and
the conditioned decode's, in bf16, f16 and fp32; one captured graph
replayed at several positions; a cache tail poisoned with NaN past the live
position; the inputs it refuses. This file imports no JAX, so on a GPU host
without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_decode_attention.py -q
"""
import pytest
import torch

from eioku_tpu_torch.models import layers
from eioku_tpu_torch.models.whisper import decoding, model
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens
from eioku_tpu_torch.ops import _cuda
from eioku_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    launches,
)
from eioku_tpu_torch.utils.metrics import METRICS

HEADS, WIDTH = 6, 384  # Whisper tiny: head dim 64


def _rand(shape, g, dtype=torch.float32, device="cpu"):
    return torch.randn(shape, generator=g).to(device, dtype)


def _live(n: int, pos: torch.Tensor) -> torch.Tensor:
    """The decoder's self-attention mask: positions 0..pos."""
    return (torch.arange(n, device=pos.device) <= pos)[None, None, None]


# -- on the CPU ----------------------------------------------------------------------------


@pytest.mark.parametrize("b_cross", [1, 2])
@pytest.mark.parametrize("pos", [0, 5, 15])  # 15: the last of the cache's n = 16
def test_plain_self_attention_is_the_masked_attend(pos, b_cross):
    g = torch.Generator().manual_seed(pos * 10 + b_cross)
    n = 16
    q = _rand((b_cross, 1, WIDTH), g)
    k, v = _rand((b_cross, n, WIDTH), g), _rand((b_cross, n, WIDTH), g)
    p = torch.tensor([pos])
    want = model._attend(q, k, v, HEADS, mask=_live(n, p))
    assert torch.equal(decode_attention_plain(q, k, v, HEADS, pos=p), want)
    assert torch.equal(decode_attention(q, k, v, HEADS, pos=p), want)


def _attend_grouped(q, k, v, n_heads: int) -> torch.Tensor:
    """The decoder's grouped cross-attention as it was before the decode
    attention op took its place: q [B*G, Sq, d]; k/v [B, Sk, d]."""
    b = k.shape[0]
    g = q.shape[0] // b
    hd = q.shape[-1] // n_heads
    scale = hd ** -0.25
    qh = layers.split_heads(q, n_heads) * scale
    kh = layers.split_heads(k, n_heads) * scale
    vh = layers.split_heads(v, n_heads)
    qh = qh.reshape(b, g, n_heads, q.shape[1], hd)
    scores = torch.einsum("bghqd,bhkd->bghqk", qh.float(), kh.float())
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    out = torch.einsum("bghqk,bhkd->bghqd", w, vh)
    return layers.merge_heads(out.reshape(q.shape[0], n_heads, q.shape[1], hd))


@pytest.mark.parametrize("b_cross", [1, 2])
@pytest.mark.parametrize("group", [1, 5])
def test_plain_cross_attention_is_attend_grouped(group, b_cross):
    """The beams of a window (G consecutive query rows) share its encoder
    K/V; G = 1 is the ungrouped `_attend` as well."""
    g = torch.Generator().manual_seed(group * 10 + b_cross)
    q = _rand((b_cross * group, 1, WIDTH), g)
    k, v = _rand((b_cross, model.N_AUDIO_CTX, WIDTH), g), _rand((b_cross, model.N_AUDIO_CTX,
                                                                 WIDTH), g)
    want = _attend_grouped(q, k, v, HEADS)
    assert torch.equal(decode_attention_plain(q, k, v, HEADS), want)
    assert torch.equal(decode_attention(q, k, v, HEADS), want)
    if group == 1:
        assert torch.equal(want, model._attend(q, k, v, HEADS))


def test_plain_refuses_what_is_not_one_position():
    g = torch.Generator().manual_seed(0)
    k = _rand((2, 8, WIDTH), g)
    with pytest.raises(ValueError):  # two query positions
        decode_attention(_rand((2, 2, WIDTH), g), k, k, HEADS)
    with pytest.raises(ValueError):  # rows that do not group onto the K/V rows
        decode_attention(_rand((3, 1, WIDTH), g), k, k, HEADS)
    with pytest.raises(ValueError):  # more than one position
        decode_attention(_rand((2, 1, WIDTH), g), k, k, HEADS, pos=torch.tensor([1, 2]))


@pytest.fixture(scope="module")
def tiny():
    m = model.init_whisper(model.WhisperConfig("tiny"), torch.Generator().manual_seed(0))
    m.decoder.token_embedding.weight.data.mul_(50.0)
    return m.eval()


def test_cpu_step_takes_the_plain_version(tiny, monkeypatch):
    """No kernel launch: `_cuda.launch` is never reached, the count stays."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU step reached a kernel launch")
    monkeypatch.setattr(_cuda, "launch", refuse)
    cfg = tiny.cfg
    g = torch.Generator().manual_seed(3)
    cross_k, cross_v = model.precompute_cross_kv(tiny, _rand((2, model.N_AUDIO_CTX, cfg.dim), g))
    tokens = torch.randint(0, cfg.vocab_size, (10, 8), generator=g)
    cache = (cfg.n_dec_layers, 10, 8, cfg.dim)
    self_k, self_v = torch.zeros(cache), torch.zeros(cache)
    before = launches()
    for pos in range(3):
        logits = model.decoder_step(tiny, cross_k, cross_v, tokens, self_k, self_v, pos)
        assert torch.isfinite(logits).all()
    assert launches() == before


def test_kernel_steps_read_zero_on_the_cpu(tiny):
    tk = WhisperTokens(tiny.cfg.vocab_size)
    enc = _rand((2, model.N_AUDIO_CTX, tiny.cfg.dim), torch.Generator().manual_seed(4))
    init = torch.tensor([tk.sot_sequence("en")] * 2)
    sa, sb = decoding.build_suppress_masks(tk, timestamps=True)
    with METRICS.task("transcription"):
        decoding.whisper_decode_windows(tiny, enc, init, sa, sb, max_len=10, beam_size=3)
    counters = METRICS.recent_tasks()[-1]["counters"]
    assert counters["decode_steps"] > 0
    assert counters["decode_attn_kernel_steps"] == 0


# -- on the card ----------------------------------------------------------------------------

# large-v3's decoder: 20 heads of 64
L_HEADS, L_WIDTH = 20, 1280
# The kernel's tolerance against the plain version. bf16: 1 bf16 ulp of the
# output plus 2^-8 sum_j p_j |v_j|; f16: 1 f16 ulp plus 2^-11 sum_j p_j |v_j|.
# The output is rounded once from an fp32 sum in another order (1 ulp), and a
# score summed in another order may round its p_j to the neighbouring value
# (one ulp of p_j, at most 2^-7 p_j in bf16, on the rare j whose p sits at a
# rounding midpoint). fp32: 2e-5 absolute, the fp32 sums' order alone.


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the decode attention kernel has no "
                    "CPU mode (its plain version runs above)")
    return "cuda"


def _ulp(x: torch.Tensor, bits: int, min_exp: int) -> torch.Tensor:
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** min_exp)))
    return torch.exp2(e - (bits - 1))


def _excess(got, want, weight) -> float:
    """The largest error past the tolerance above; <= 0 within it."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float((diff - 2e-5).max())
    top = got.float().abs().maximum(want.float().abs())
    if got.dtype == torch.bfloat16:
        return float((diff - _ulp(top, 8, -126) - 2.0 ** -8 * weight).max())
    return float((diff - _ulp(top, 11, -14) - 2.0 ** -11 * weight).max())


def _case(card, dtype, rows, windows, frames, seed):
    g = torch.Generator().manual_seed(seed)
    q = _rand((rows, 1, L_WIDTH), g, dtype, card)
    k = _rand((windows, frames, L_WIDTH), g, dtype, card)
    v = _rand((windows, frames, L_WIDTH), g, dtype, card)
    return q, k, v


def _check(q, k, v, pos=None):
    got = decode_attention(q, k, v, L_HEADS, pos=pos)
    want = decode_attention_plain(q, k, v, L_HEADS, pos=pos)
    weight = decode_attention_plain(q.float(), k.float(), v.float().abs(), L_HEADS, pos=pos)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    excess = _excess(got, want, weight)
    assert excess <= 0, f"{q.dtype}: past the tolerance by {excess}"


DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "fp32"])
@pytest.mark.parametrize("pos", [0, 3, 63, 127, 255])
def test_kernel_self_attention_at_the_cells_shape(card, dtype, pos):
    """40 beam rows (8 windows x 5), a cache of 256 positions."""
    q, k, v = _case(card, dtype, 40, 40, 256, pos)
    _check(q, k, v, torch.tensor([pos], device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "fp32"])
def test_kernel_cross_attention_at_the_cells_shape(card, dtype):
    """8 windows x 1500 frames, 5 beams a window."""
    q, k, v = _case(card, dtype, 40, 8, model.N_AUDIO_CTX, 11)
    _check(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "fp32"])
@pytest.mark.parametrize("pos", [130, 447])
def test_kernel_at_the_conditioned_decodes_shape(card, dtype, pos):
    """5 beam rows of one window: self over 448 positions, cross over its
    1500 frames."""
    q, k, v = _case(card, dtype, 5, 5, 448, pos)
    _check(q, k, v, torch.tensor([pos], device=card))
    q, k, v = _case(card, dtype, 5, 1, model.N_AUDIO_CTX, pos + 1)
    _check(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 8, 10])
def test_kernel_groups(card, group):
    """Groups up to 8 rows a launch, and 10 in two slices."""
    q, k, v = _case(card, torch.bfloat16, 3 * group, 3, 700, group)
    _check(q, k, v)


@pytest.mark.cuda
def test_one_graph_serves_every_position(card):
    """The position is read on the device: one capture, replayed at several
    positions, gives the eager result at each, bit for bit."""
    q, k, v = _case(card, torch.bfloat16, 40, 40, 256, 5)
    pos = torch.zeros(1, dtype=torch.long, device=card)
    eager = {}
    for p in (0, 3, 100, 255):
        eager[p] = decode_attention(q, k, v, L_HEADS, pos=torch.tensor([p], device=card))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, k, v, L_HEADS, pos=pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, L_HEADS, pos=pos)
    for p in (255, 0, 100, 3):
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, eager[p])


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 17, 200])
def test_nothing_past_the_live_position_is_read(card, pos):
    q, k, v = _case(card, torch.bfloat16, 40, 40, 256, pos + 7)
    p = torch.tensor([pos], device=card)
    clean = decode_attention(q, k, v, L_HEADS, pos=p)
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    poisoned = decode_attention(q, k, v, L_HEADS, pos=p)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(card):
    q, k, v = _case(card, torch.bfloat16, 10, 2, 64, 0)
    with pytest.raises(ValueError):  # head dim 128
        decode_attention(q, k, v, L_HEADS // 2)
    with pytest.raises(TypeError):
        decode_attention(q.double(), k.double(), v.double(), L_HEADS)
    wide = torch.zeros((2, 64, L_WIDTH + 1), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):  # frames 1281 elements apart: not whole 16 bytes
        decode_attention(q, wide[..., :L_WIDTH], wide[..., :L_WIDTH], L_HEADS)
