"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode) and
skip elsewhere; the plain versions are held against the JAX package by
test_torch_ops.py. This file imports no JAX, so on a GPU host without JAX
it runs on its own, past the repository's JAX-loading conftest files:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from eioku_tpu_torch.ops.nms import MAX_CANDIDATES, nms_keep_mask, nms_keep_mask_plain
from eioku_tpu_torch.ops.scene_diff import pair_diff, pair_diff_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions run in test_torch_ops.py)")
    return torch.device("cuda")


def _nms_workload(b, k, seed, pad_from, n_classes=3):
    """Dense overlapping candidates as in tests/test_nms_kernel.py, sorted
    by score, with a zero-score padding tail."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (b, k, 2))
    wh = rng.uniform(5, 40, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.1, 1.0, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    scores[:, pad_from:] = 0.0
    classes = rng.integers(0, n_classes, (b, k)).astype(np.int32)
    return boxes, scores, classes


def _assert_nms_equals_plain(boxes, scores, classes, device):
    boxes, scores, classes = (torch.from_numpy(a).to(device)
                              for a in (boxes, scores, classes))
    got = nms_keep_mask(boxes, scores, classes, 0.45)
    want = nms_keep_mask_plain(boxes, scores, classes, 0.45)
    # a discrete output: exactly equal
    assert torch.equal(got, want)
    assert not (got & (scores <= 0)).any()


# the main path's chunk [SCENE_CHUNK + 1, 96*160*3], a ragged shape (odd N,
# D not a multiple of 4: the kernel's scalar path) and the smallest chain
@pytest.mark.parametrize("n,d", [(257, 96 * 160 * 3), (67, 1001), (2, 3)])
def test_scene_diff_kernel_matches_plain(cuda_device, n, d):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    chain = torch.rand((n, d), generator=g, device=cuda_device)
    got = pair_diff(chain)
    torch.cuda.synchronize()
    # scores lie in [0, 1]; the kernel sums in another order
    torch.testing.assert_close(got, pair_diff_plain(chain), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [256, 300, 512, 1024])
def test_nms_kernel_equals_plain(cuda_device, k):
    boxes, scores, classes = (torch.from_numpy(a).to(cuda_device) for a in
                              _nms_workload(64, k, seed=k, pad_from=k - k // 5))
    got = nms_keep_mask(boxes, scores, classes, 0.45)
    want = nms_keep_mask_plain(boxes, scores, classes, 0.45)
    # a discrete output: exactly equal
    assert torch.equal(got, want)
    assert not got[:, k - k // 5:].any()


# the bitmask's word edges (one rank, one short of a word, one past it),
# 8,400 candidates (every anchor of a 640 x 640 input), the kernel's limit
# and the main path's 80 classes; the face detector's one class (every
# pair IoU-tested) at the face consumer's 32-slot bucket and the fused
# gather's 22 slots
@pytest.mark.parametrize("b,k,n_classes", [(2, 1, 3), (2, 63, 3), (2, 65, 3),
                                           (2, 8400, 3), (1, MAX_CANDIDATES, 3),
                                           (64, 256, 80), (4, 1024, 80),
                                           (32, 256, 1), (22, 256, 1)])
def test_nms_kernel_equals_plain_at_word_edges(cuda_device, b, k, n_classes):
    _assert_nms_equals_plain(*_nms_workload(b, k, seed=k, pad_from=k - k // 5,
                                            n_classes=n_classes), cuda_device)


def test_nms_kernel_keeps_nothing_of_all_padding(cuda_device):
    boxes, _, classes = _nms_workload(2, 300, seed=5, pad_from=0)
    _assert_nms_equals_plain(boxes, np.zeros((2, 300), np.float32), classes,
                             cuda_device)


def test_nms_kernel_on_zero_area_and_inverted_boxes(cuda_device):
    boxes, scores, classes = _nms_workload(2, 150, seed=9, pad_from=140)
    boxes[:, 0::5, 2] = boxes[:, 0::5, 0]  # zero width
    boxes[:, 1::5, 3] = boxes[:, 1::5, 1]  # zero height
    boxes[:, 2::5] = boxes[:, 2::5][..., [2, 3, 0, 1]]  # inverted
    _assert_nms_equals_plain(boxes, scores, classes, cuda_device)


def test_nms_kernel_keeps_one_of_identical_boxes(cuda_device):
    # one box 300 times: per image and class only the first survives
    boxes = np.tile(np.float32([10, 20, 50, 60]), (2, 300, 1))
    scores = np.linspace(1.0, 0.1, 300, dtype=np.float32)[None].repeat(2, 0)
    classes = np.zeros((2, 300), np.int32)
    classes[1] = np.arange(300) % 2
    _assert_nms_equals_plain(boxes, scores, classes, cuda_device)


def test_nms_kernel_decides_ious_at_the_threshold(cuda_device):
    # A = [0, 0, W, 1], B = [0, 0, w, 1]: IoU = w / W within 4 ulps of 0.45,
    # inside the band where the kernel's suppression test divides
    n = 256
    big = np.float32(1) + np.arange(n, dtype=np.float32) * np.float32(2.0 ** -8)
    small = big * np.float32(0.45)
    for i, steps in enumerate(np.arange(n) % 9 - 4):
        for _ in range(abs(steps)):
            small[i] = np.nextafter(small[i], np.float32(np.inf if steps > 0 else 0))
    boxes = np.zeros((1, 2 * n, 4), np.float32)
    boxes[0, :, 3] = 1
    boxes[0, 0::2, 2], boxes[0, 1::2, 2] = big, small
    scores = np.linspace(1.0, 0.1, 2 * n, dtype=np.float32)[None]
    classes = (np.arange(2 * n) // 2).astype(np.int32)[None]
    _assert_nms_equals_plain(boxes, scores, classes, cuda_device)


def test_nms_wrapper_rejects_inputs_on_two_devices(cuda_device):
    boxes, scores, classes = (torch.from_numpy(a) for a in
                              _nms_workload(2, 16, seed=0, pad_from=16))
    with pytest.raises(ValueError, match="one device"):
        nms_keep_mask(boxes.to(cuda_device), scores, classes.to(cuda_device))


def test_nms_kernel_rejects_a_pool_beyond_shared_memory(cuda_device):
    # one past the kernel's limit: the scan's two staged bitmask tiles and
    # five removed words per lane cover 10,240 candidates
    k = MAX_CANDIDATES + 1
    boxes = torch.zeros((1, k, 4), device=cuda_device)
    scores = torch.ones((1, k), device=cuda_device)
    classes = torch.zeros((1, k), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="nms"):
        nms_keep_mask(boxes, scores, classes, 0.45)


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _f16_ulp(x):
    """Spacing of f16 values at |x| (11 significant bits; subnormals below
    2^-14 are spaced 2^-24)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -14)))
    return torch.exp2(e - 10)


def _qkv(shape, dtype, device, seed, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(shape, generator=g, device=device) * scale).to(dtype)
            for _ in range(3)]


def _assert_flash_close(got, want, cancel):
    """fp32: 2e-5 absolute (fp32 FMAs in another order: the Pallas kernel's
    own tolerance). bf16: within 1 bf16 ulp of the plain version, which
    computes in fp32 from the same bf16 inputs and rounds once, plus
    2^-8 * sum_j p_j |v_j| (`cancel`). The kernel rounds P to bf16 once
    before P V, a relative error of at most 2^-9 in each p, so the weighted
    sum moves by at most 2^-9 * sum_j p_j |v_j| (with l summed from the
    unrounded p); the bound doubles that for the order of the fp32 sums and
    the exp2 approximation. It shows only where the output cancels to near
    zero; elsewhere the 1 ulp dominates. f16: 1 f16 ulp plus 2^-11 * sum_j
    p_j |v_j|, the rounding of each p to f16's 11 significant bits (the
    fp32 sums' order and exp2's error lie three orders below it)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        return
    diff = (got.float() - want.float()).abs()
    top = torch.maximum(got.float().abs(), want.float().abs())
    if got.dtype == torch.float16:
        excess = diff - _f16_ulp(top) - 2.0 ** -11 * cancel
        assert bool((excess <= 0).all()), float(excess.max())
        return
    ulp = _bf16_ulp(top)
    excess = diff - ulp - 2.0 ** -8 * cancel
    assert bool((excess <= 0).all()), float(excess.max())


def _check_flash(shape, dtype, causal, lengths, device, seed=None):
    from eioku_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    q, k, v = _qkv(shape, dtype, device, seed=shape[2] if seed is None else seed)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                     device=device)
    got = flash_attention(q, k, v, lengths=lens, causal=causal)
    want = flash_attention_plain(q, k, v, lengths=lens, causal=causal)
    cancel = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   lengths=lens, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    if lengths is not None and lengths[0] == 0:
        assert not bool(got[0].any())  # no valid key: zeros, not NaN
    _assert_flash_close(got, want, cancel)


# the Whisper large-v3 encoder's shape (bf16 on the path, f16 with
# compute_dtype float16, f32 with float32), a causal ragged case, MiniLM's
# lengths case
@pytest.mark.parametrize("shape,dtype,causal,lengths", [
    ((4, 20, 1500, 64), torch.bfloat16, False, None),
    ((4, 20, 1500, 64), torch.float16, False, None),
    ((2, 12, 512, 32), torch.float16, False, [512, 130]),
    ((2, 2, 130, 64), torch.float16, True, [0, 100]),
    ((4, 20, 1500, 64), torch.float32, False, None),
    ((2, 4, 200, 64), torch.float32, True, None),
    ((2, 12, 512, 32), torch.bfloat16, False, [512, 130]),
    ((2, 2, 77, 32), torch.float32, False, [0, 77]),
    ((2, 2, 130, 64), torch.bfloat16, True, [0, 100]),
])
def test_flash_attention_kernel_matches_plain(cuda_device, shape, dtype, causal,
                                              lengths):
    _check_flash(shape, dtype, causal, lengths, cuda_device)


# the bf16 kernel's edges: one key, exactly one 128-key tile, one key past
# it, a ragged tail (TMA zero fill), at both head dims
@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("s", [1, 128, 129, 300])
def test_flash_attention_bf16_kernel_sequence_edges(cuda_device, s, d):
    _check_flash((2, 3, s, d), torch.bfloat16, False, None, cuda_device)


# the f16 instantiation at the same edges
@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("s", [1, 129, 300])
def test_flash_attention_f16_kernel_sequence_edges(cuda_device, s, d):
    _check_flash((2, 3, s, d), torch.float16, False, None, cuda_device)


# lengths around a KV tile boundary; batch row 1 has no valid key
@pytest.mark.parametrize("length", [127, 128, 129])
def test_flash_attention_bf16_kernel_lengths_at_a_tile_boundary(cuda_device, length):
    _check_flash((2, 2, 300, 64), torch.bfloat16, False, [length, 0], cuda_device)
    _check_flash((2, 2, 300, 64), torch.bfloat16, False, [0, length], cuda_device)


def test_flash_attention_bf16_kernel_causal(cuda_device):
    # 300 rows: two query tiles, the diagonal inside both, a ragged key tile
    _check_flash((2, 4, 300, 64), torch.bfloat16, True, None, cuda_device)


@pytest.mark.parametrize("d", [64, 32])
def test_flash_attention_kernel_reads_strided_heads(cuda_device, d):
    # the encoder's layout: [B, S, H, D] projections viewed as [B, H, S, D]
    # (the tensor maps step S by H * D); equal bit for bit to dense inputs
    from eioku_tpu_torch.ops.flash_attention import flash_attention

    b, s, h = 2, 300, 6
    q, k, v = (t.view(b, s, h, d).transpose(1, 2) for t in
               _qkv((b, s, h * d), torch.bfloat16, cuda_device, seed=3))
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _check_flash((b, h, s, d), torch.bfloat16, False, None, cuda_device, seed=3)


def test_flash_attention_kernel_refuses_other_inputs(cuda_device):
    from eioku_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = _qkv((1, 2, 64, 48), torch.bfloat16, cuda_device, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 64, 64), torch.float64, cuda_device, seed=0)
    with pytest.raises(TypeError, match="bf16, f16 or fp32"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 64, 64), torch.float16, cuda_device, seed=0)
    with pytest.raises(TypeError, match="of one type"):
        flash_attention(q, k.to(torch.bfloat16), v)


# MiniLM's K3 route: S = 512 with per-row lengths, [B, H, S, 32] views of
# the [B, S, d] projections; one K3 launch per layer
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minilm_at_512_launches_k3_and_matches_the_cpu(cuda_device, monkeypatch, dtype):
    from dataclasses import replace

    from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, init_minilm, minilm_embed
    from eioku_tpu_torch.ops import _cuda

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = MiniLMConfig()
    cpu = init_minilm(cfg, torch.Generator().manual_seed(0))
    card = init_minilm(cfg, torch.Generator().manual_seed(0), cuda_device)
    card.cfg = replace(cfg, compute_dtype="bfloat16" if dtype == torch.bfloat16
                       else "float32")
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 512), generator=g)
    mask = torch.zeros((4, 512), dtype=torch.int32)
    for row, length in enumerate((512, 130, 1, 300)):
        mask[row, :length] = 1
    want = minilm_embed(cpu, ids, mask)
    _cuda.reset_launch_counts()
    got = minilm_embed(card, ids.to(cuda_device), mask.to(cuda_device)).cpu()
    assert _cuda.launch_counts()["flash_attention"] == cfg.n_layers
    if dtype == torch.float32:
        # fp32 card (TF32 off) against the CPU: 1e-4 per entry
        assert float((got - want).abs().max()) <= 1e-4
    else:
        # bf16 activations against fp32: cosine of unit vectors >= 0.995
        assert float((got * want).sum(-1).min()) >= 0.995


def test_topk_cosine_tie_order_on_the_card(cuda_device):
    from eioku_tpu_torch.index.semantic import _topk_cosine

    g = torch.Generator().manual_seed(2)
    v = torch.randn((20000, 384), generator=g)
    v[5000:5040] = v[11]  # exact ties: the lower index must come first
    v[19999] = v[11]
    v = (v / v.norm(dim=1, keepdim=True)).half()
    q = v[11].float() + 0.01 * torch.randn(384, generator=g)
    for k in (1, 10, 64):
        want_s, want_i = _topk_cosine(v, q, k)
        got_s, got_i = _topk_cosine(v.to(cuda_device), q.to(cuda_device), k)
        assert torch.equal(got_i.cpu(), want_i)
        assert float((got_s.cpu() - want_s).abs().max()) <= 1e-5
    assert got_i[:3].tolist() == [11, 5000, 5001]
