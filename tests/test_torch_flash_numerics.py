"""The bf16 tolerance of K3 (csrc/flash_attention.cu) against the JAX package.

The CUDA kernel runs only on the card; what this file checks on the CPU is
that its arithmetic stays within the tolerance the card tests hold it to.
`_emulate_kernel` repeats that arithmetic in torch: bf16 inputs, fp32
scores in the exp2 domain (scale * log2 e folded in, MASK_VALUE after the
scaling), an online softmax over 128-key tiles with fp32 m and l, l summed
from the fp32 p, P rounded to bf16 once, fp32 accumulation of P V, and one
rounding of the output to bf16. It is held against the JAX package's
`_reference_attention` (fp32 on the same bf16 values, rounded once to
bf16) and against the port's plain version, within

    1 bf16 ulp + 2^-8 * sum_j p_j |v_j|

per element: 2^-9 for the rounding of each p, doubled for the order of the
fp32 sums and the card's exp2 approximation. The emulation lives here only;
nothing in the package uses it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eioku_tpu.ops.flash_attention import _reference_attention
from eioku_tpu_torch.ops.flash_attention import MASK_VALUE, flash_attention_plain

BLOCK_K = 128  # the kernel's keys per KV tile


def _emulate_kernel(q, k, v, lengths, causal, scale):
    """The kernel's bf16 route in torch: [B, H, S, D] bf16 -> bf16."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    x = s * (scale * math.log2(math.e))
    col = torch.arange(skv)
    valid = (col[None, :] < lengths[:, None])[:, None, None, :]
    if causal:
        valid = valid & (col[None, :] <= torch.arange(sq)[:, None])[None, None]
    x = torch.where(valid, x, torch.tensor(MASK_VALUE))
    out = torch.zeros((b, h, sq, d))
    for i in range(b):  # tiles past a row's length are skipped, as on the card
        m = torch.full((h, sq, 1), -math.inf)
        l = torch.zeros((h, sq, 1))
        acc = torch.zeros((h, sq, d))
        for t in range(-(-int(lengths[i]) // BLOCK_K)):
            xt = x[i, :, :, t * BLOCK_K:(t + 1) * BLOCK_K]
            m_next = torch.maximum(m, xt.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_next)
            p = torch.exp2(xt - m_next)
            l = l * alpha + p.sum(-1, keepdim=True)
            vt = v[i, :, t * BLOCK_K:(t + 1) * BLOCK_K].float()
            acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
            m = m_next
        out[i] = torch.where(l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    return out.to(torch.bfloat16)


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _excess(got, want, cancel):
    """Largest (error - 1 ulp - 2^-8 sum_j p_j |v_j|) over the elements."""
    got, want = got.float(), want.float()
    tol = _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 2.0 ** -8 * cancel
    return float(((got - want).abs() - tol).max())


def _jax_reference(q, k, v, lengths, causal, scale):
    out = _reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths), causal, scale)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("shape,causal,lengths,cancelling", [
    ((1, 2, 300, 64), False, None, False),       # encoder-like, ragged tile
    ((1, 2, 300, 64), True, None, False),
    ((1, 2, 300, 64), False, None, True),        # zero-mean V: outputs cancel
    ((2, 2, 130, 32), False, (130, 77), False),  # MiniLM-like with lengths
    ((2, 2, 130, 32), True, (130, 60), True),
    ((2, 2, 130, 32), False, (0, 129), False),   # a row with no valid key
])
def test_kernel_arithmetic_within_bf16_tolerance_of_jax(shape, causal, lengths,
                                                        cancelling):
    b, h, s, d = shape
    rng = np.random.default_rng(s + d + int(causal))
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if cancelling:
        v -= v.mean(axis=2, keepdims=True)
    # bf16 inputs; JAX gets the same values in fp32
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    lens = torch.tensor(lengths if lengths else (s,) * b, dtype=torch.int32)
    scale = d ** -0.5
    got = _emulate_kernel(q, k, v, lens, causal, scale)
    f32 = [t.float().numpy() for t in (q, k, v)]
    want = _jax_reference(*f32, lens.numpy(), causal, scale).to(torch.bfloat16)
    cancel = _jax_reference(f32[0], f32[1], np.abs(f32[2]), lens.numpy(), causal,
                            scale)
    assert got.shape == want.shape and bool(torch.isfinite(got.float()).all())
    assert _excess(got, want, cancel) <= 0
    # and the port's plain version, which chip_smoke.py and the card tests
    # compare the kernel with
    plain = flash_attention_plain(q, k, v, lengths=lens if lengths else None,
                                  causal=causal, scale=scale)
    assert _excess(got, plain, cancel) <= 0
    if lengths and lengths[0] == 0:
        assert not bool(got[0].float().any())  # zeros, not NaN


def test_bf16_p_needs_more_than_the_split_p_bound():
    # with V cancelling, rounding P to bf16 moves outputs by far more than
    # the 2^-16 * sum p|v| a split P kept: the reason the bound is 2^-8
    shape = (1, 2, 300, 64)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    v -= v.mean(axis=2, keepdims=True)
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    lens = torch.tensor([300], dtype=torch.int32)
    got = _emulate_kernel(q, k, v, lens, False, 0.125).float()
    f32 = [t.float().numpy() for t in (q, k, v)]
    want = _jax_reference(*f32, lens.numpy(), False, 0.125)
    cancel = _jax_reference(f32[0], f32[1], np.abs(f32[2]), lens.numpy(), False, 0.125)
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    err = (got - want).abs() - ulp
    assert float((err - 2.0 ** -16 * cancel).max()) > 0
    assert float((err - 2.0 ** -8 * cancel).max()) <= 0
