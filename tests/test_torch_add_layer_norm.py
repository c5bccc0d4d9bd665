"""The tail of a residual branch and the next LayerNorm as one op
(ops/add_layer_norm.py, the kernel csrc/add_layer_norm.cu), and the Whisper
decoder step that runs it (models/whisper/model.py `_decoder_step_static`).

On the CPU: the plain version against the operations it replaced (the
`Linear` bias add, the residual add, then `layers.layer_norm`) bit for bit,
in fp32 and bf16, with and without a product and a bias; `decoder_step`
against the step as it ran before the op, bit for bit, so the JAX parity
tests of the step hold as they were. The tests marked `cuda` run on an
NVIDIA GPU (skipped elsewhere): the kernel against the plain version at the
cell's [40, 1, 1280] and rows 1-64 at every Whisper width, in bf16, f16 and
fp32 (the residual bit for bit; h within the tolerance below, one ulp of
the normalised value in 16-bit types and four in fp32, and in 16-bit
types at least 99% bit for bit); the inputs it refuses; 97 launches in an
eager large-v3-shaped step. This file imports no JAX, so on a GPU host
without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_add_layer_norm.py -q
"""
import pytest
import torch
import torch.nn.functional as F

from eioku_tpu_torch.models import layers
from eioku_tpu_torch.models.whisper import model
from eioku_tpu_torch.ops import _cuda
from eioku_tpu_torch.ops.add_layer_norm import (
    add_layer_norm,
    add_layer_norm_plain,
    launches,
)
from eioku_tpu_torch.ops.decode_attention import decode_attention

EPS = 1e-5
MODES = ["ln", "y", "y+b"]  # the LayerNorm alone; after a product; after a product and bias


def _inputs(shape, dtype, g, device="cpu"):
    """x, y, b, w, beta at the scales of a decoder's residual stream: w and
    beta away from the identity so that each rounding point shows."""
    d = shape[-1]

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(s, generator=g) * scale + shift).to(device, dtype)
    return (r(*shape, scale=3.0, shift=0.5), r(*shape), r(d, scale=0.1), r(d, scale=0.3, shift=1.0),
            r(d, scale=0.1))


def _args(mode, y, b):
    return {"ln": {}, "y": {"y": y}, "y+b": {"y": y, "b": b}}[mode]


# -- on the CPU ----------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [384, 1280])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_is_the_replaced_sequence(dtype, d, mode):
    """`Linear`'s bias add and the residual add (x + lin(inp)), then
    `layers.layer_norm`: x and h equal bit for bit, x updated in place (and
    left as it was by the LayerNorm alone)."""
    g = torch.Generator().manual_seed(d)
    x, _, _, w, beta = _inputs((6, 1, d), dtype, g)
    lin = layers.Linear(2 * d, d, bias=mode == "y+b").to(dtype)
    if lin.bias is not None:
        lin.bias.data.normal_(0.0, 0.1, generator=g)
    inp = torch.randn((6, 1, 2 * d), generator=g).to(dtype)
    want_x = x if mode == "ln" else x + lin(inp)
    want_h = layers.layer_norm(want_x, w, beta, EPS)
    y = F.linear(inp, lin.weight)
    got_x = x.clone()
    got_h = add_layer_norm(got_x, w, beta, EPS, **_args(mode, y, lin.bias))
    assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)
    assert got_h.dtype == dtype and got_h.shape == x.shape


def test_plain_refuses_what_is_not_a_branch_tail():
    g = torch.Generator().manual_seed(0)
    x, y, b, w, beta = _inputs((4, 16), torch.float32, g)
    with pytest.raises(ValueError):  # a bias with no product
        add_layer_norm(x, w, beta, EPS, b=b)
    with pytest.raises(ValueError):  # shapes differ
        add_layer_norm(x, w, beta, EPS, y=y[:2])
    with pytest.raises(ValueError):  # gamma of another width
        add_layer_norm(x, w[:8], beta, EPS)


@torch.no_grad()
def _step_before(m, buf: model.DecodeBuffers) -> torch.Tensor:
    """The one-device step as it ran before the op: each LayerNorm a module
    call, each residual branch `x + lin(...)` with the bias in `Linear`."""
    cfg, dec, pos = m.cfg, m.decoder, buf.pos
    tok = buf.tokens.gather(1, pos.expand(buf.tokens.shape[0], 1))
    x = (dec.token_embedding.weight[tok]
         + dec.positional_embedding.index_select(0, pos)[None]).to(cfg.dtype)
    for li, block in enumerate(dec.blocks):
        h = block.attn_ln(x)
        at, ca = block.attn, block.cross_attn
        buf.self_k[li].index_copy_(1, pos, at.key(h))
        buf.self_v[li].index_copy_(1, pos, at.value(h))
        x = x + at.out(decode_attention(at.query(h), buf.self_k[li], buf.self_v[li],
                                        cfg.n_heads, pos=pos))
        x = x + ca.out(decode_attention(ca.query(block.cross_attn_ln(x)), buf.cross_k[li],
                                        buf.cross_v[li], cfg.n_heads))
        x = x + model._mlp(block.mlp_ln(x), block)
    return model._logits(m, dec.ln(x)[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_step_gives_the_logits_it_gave(dtype):
    """Tiny Whisper with its biases and LayerNorms drawn away from zero and
    the identity, 3 windows of 2 beams over 6 positions: logits and caches
    bit for bit against the step before the op, on the CPU."""
    cfg = model.WhisperConfig("tiny", compute_dtype=dtype)
    g = torch.Generator().manual_seed(5)
    m = model.init_whisper(cfg, g)
    m.decoder.token_embedding.weight.data.mul_(50.0)
    for name, p in m.decoder.named_parameters():
        if name.endswith("bias"):
            p.data.normal_(0.0, 0.1, generator=g)
        elif name.endswith("ln.weight"):
            p.data.normal_(1.0, 0.2, generator=g)
    m = m.to(cfg.dtype).eval()
    enc = torch.randn((3, model.N_AUDIO_CTX, cfg.dim), generator=g).to(cfg.dtype)
    rows, n = 6, 8
    tokens = torch.randint(0, cfg.vocab_size, (rows, n), generator=g)
    bufs = []
    for _ in range(2):
        buf = model.decode_buffers(m, enc, rows, n)
        model.precompute_cross_kv(m, enc, out=(buf.cross_k, buf.cross_v))
        buf.tokens.copy_(tokens)
        buf.self_k.zero_()
        buf.self_v.zero_()
        bufs.append(buf)
    new, old = bufs
    for pos in range(6):
        new.pos.fill_(pos)
        old.pos.fill_(pos)
        got = model._decoder_step_static(m, new)
        assert torch.equal(got, _step_before(m, old))
        assert torch.equal(new.self_k, old.self_k) and torch.equal(new.self_v, old.self_v)
    assert not new.norm_kernel  # the CPU runs the plain version


# -- on the card ----------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32]
WIDTHS = [384, 512, 768, 1024, 1280]  # every Whisper width
_BITS = {torch.bfloat16: (8, -126), torch.float16: (11, -14), torch.float32: (24, -126)}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the add-and-LayerNorm kernel has no "
                    "CPU mode (its plain version runs above)")
    return "cuda"


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    bits, min_exp = _BITS[dtype]
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** min_exp)))
    return torch.exp2(e - (bits - 1))


def _h_excess(got, want, x, w) -> float:
    """The largest error of h past its tolerance; <= 0 within it. The kernel
    sums the fp32 mean and variance in another order, which may move the
    normalised value n = T((x - mu) rsqrt(var + eps)) across a rounding
    boundary of T: one ulp of T at the row's scale (its largest |n|, at
    least 1), carried through gamma (times |w|, plus the product's own
    rounding) and beta (plus h's own rounding). In fp32, where n keeps
    every last bit of the statistics, 4 ulps: mu and var summed in another
    order each move a bit or two, and rsqrtf (within 2 ulps on each side)
    turns a variance one ulp apart into an rstd up to a few apart."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    n = ((xf - mu) * torch.rsqrt(var + EPS)).to(x.dtype).float()
    scale = n.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    wf = w.float()
    ulps = 4 if x.dtype == torch.float32 else 1
    tol = (ulps * _ulp(scale, x.dtype) * wf.abs() + _ulp(n * wf, x.dtype)
           + _ulp(want.float(), x.dtype))
    return float(((got.float() - want.float()).abs() - tol).max())


def _check(shape, dtype, mode, seed, card):
    g = torch.Generator().manual_seed(seed)
    x, y, b, w, beta = _inputs(shape, dtype, g, card)
    want_x = x.clone()
    want_h = add_layer_norm_plain(want_x, w, beta, EPS, **_args(mode, y, b))
    got_x = x.clone()
    got_h = add_layer_norm(got_x, w, beta, EPS, **_args(mode, y, b))
    torch.cuda.synchronize()
    assert torch.equal(got_x, want_x), f"{dtype} {shape} {mode}: the residual differs"
    assert got_h.dtype == dtype and got_h.shape == x.shape
    assert torch.isfinite(got_h).all()
    excess = _h_excess(got_h, want_h, want_x, w)
    assert excess <= 0, f"{dtype} {shape} {mode}: h past the tolerance by {excess}"
    same = float((got_h == want_h).float().mean())
    if dtype != torch.float32:  # fp32 shows every last-bit move of the statistics
        assert same >= 0.99, f"{dtype} {shape} {mode}: {same:.2%} of h bit for bit"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "fp32"])
def test_kernel_at_the_cells_shape(card, dtype, mode):
    _check((40, 1, 1280), dtype, mode, 0, card)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 40, 64])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "fp32"])
def test_kernel_rows_and_widths(card, dtype, d, rows):
    for k, mode in enumerate(MODES):
        _check((rows, d), dtype, mode, rows * 10 + k, card)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(card):
    g = torch.Generator().manual_seed(1)
    x, y, b, w, beta = _inputs((8, 1, 1280), torch.bfloat16, g, card)
    with pytest.raises(TypeError):
        add_layer_norm(x.double(), w, beta, EPS)
    with pytest.raises(TypeError):  # y of another type
        add_layer_norm(x, w, beta, EPS, y=y.float())
    for d in (1288, 100):  # past the registers' 1280; not a multiple of 8
        xs, _, _, ws, bs = _inputs((8, d), torch.bfloat16, g, card)
        with pytest.raises(ValueError):
            add_layer_norm(xs, ws, bs, EPS)
    wide = torch.zeros((8, 1284), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):  # rows 1284 elements apart: not whole 16 bytes
        add_layer_norm(wide[:, :1280], w, beta, EPS)
    with pytest.raises(ValueError):  # a base 2 bytes past 16-byte alignment
        add_layer_norm(wide.view(-1)[1:1 + 8 * 1280].view(8, 1280), w, beta, EPS)
    split = torch.zeros((2, 4, 1280), dtype=torch.bfloat16, device=card).transpose(0, 1)
    with pytest.raises(ValueError):  # leading dims that are no one row stride
        add_layer_norm(split, w, beta, EPS)


@pytest.mark.cuda
def test_an_eager_large_v3_step_launches_97(card):
    """One launch before the first layer, three a layer: 1 + 3 x 32."""
    cfg = model.WhisperConfig("large-v3", compute_dtype="bfloat16")
    with torch.device("meta"):
        m = model.Whisper(cfg)
    m = m.to_empty(device=card).to(cfg.dtype).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.02)
    enc = torch.randn((8, model.N_AUDIO_CTX, cfg.dim), device=card).to(cfg.dtype)
    buf = model.decode_buffers(m, enc, 40, 8)
    buf.cross_k.normal_()
    buf.cross_v.normal_()
    buf.self_k.zero_()
    buf.self_v.zero_()
    buf.tokens.fill_(1)
    buf.pos.fill_(3)
    before = launches()
    logits = model._decoder_step_static(m, buf)
    torch.cuda.synchronize()
    assert launches() - before == 1 + 3 * cfg.n_dec_layers == 97
    assert buf.norm_kernel and torch.isfinite(logits).all()
    assert _cuda.launch_counts()["add_layer_norm"] == launches()
