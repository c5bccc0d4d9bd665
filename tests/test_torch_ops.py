"""PyTorch port (eioku_tpu_torch.ops) against the JAX package on the CPU.

Inputs are made from seeded numpy and fed to both packages. The port's
wrappers take their plain PyTorch versions here (CPU tensors); the JAX side
runs its Pallas kernels in interpret mode where it has one. The CUDA kernels
themselves are held against the plain versions in test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.models.yolo.postprocess import nms_fixed as jax_nms_fixed
from eioku_tpu.ops import colorspace as jax_cs
from eioku_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from eioku_tpu.ops.scene_diff import scene_scores as jax_scene_scores
from eioku_tpu_torch.ops import colorspace as cs
from eioku_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain
from eioku_tpu_torch.ops.scene_diff import pair_diff, scene_scores

# colorspace and scene scores are float32 elementwise math on values in
# [0, 1]; the two frameworks may contract or order a few operations
# differently, a handful of ulps at most
ATOL = 1e-6


def _i420_planes(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, h * 3 // 2, w), dtype=np.uint8)


class TestColorspace:
    # H = 270 is even but not a multiple of 4: the U/V planes then span
    # partial rows, which only flat-offset plane slicing gets right
    @pytest.mark.parametrize("h,w", [(64, 96), (270, 64), (96, 160)])
    def test_i420_to_rgb_matches_jax(self, h, w):
        planes = _i420_planes(2, h, w, seed=h)
        want = np.asarray(jax_cs.i420_to_rgb(jnp.asarray(planes)))
        got = cs.i420_to_rgb(torch.from_numpy(planes)).numpy()
        assert got.shape == (2, h, w, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    @pytest.mark.parametrize("h,w", [(64, 96), (270, 64)])
    def test_hsv_planes_match_jax(self, h, w):
        planes = _i420_planes(3, h, w, seed=w)
        want = np.asarray(jax_cs.i420_frames_to_hsv_planes(jnp.asarray(planes)))
        got = cs.i420_frames_to_hsv_planes(torch.from_numpy(planes)).numpy()
        assert got.shape == (3, h * w * 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    def test_rgb_to_hsv_matches_jax_on_greys_and_primaries(self):
        rng = np.random.default_rng(4)
        rgb = rng.random((200, 3)).astype(np.float32)
        rgb[:20] = rgb[:20, :1]  # greys: d == 0
        rgb[20:23] = np.eye(3, dtype=np.float32)
        rgb[23] = 0.0  # black: mx == 0
        want = np.asarray(jax_cs.rgb_to_hsv(jnp.asarray(rgb)))
        got = cs.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    def test_to_i420_matches_jax(self):
        rng = np.random.default_rng(6)
        frames = list(rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8))
        np.testing.assert_array_equal(cs.to_i420(frames),
                                      jax_cs.to_i420(frames))


class TestSceneScores:
    # D not a multiple of 128 (the Pallas lane padding), B not a multiple of 8
    # (its row tiling), and a carried non-zero previous plane
    @pytest.mark.parametrize("use_pallas", [True, False])
    @pytest.mark.parametrize("b,d", [(6, 300), (13, 1001)])
    def test_plain_matches_jax(self, use_pallas, b, d):
        rng = np.random.default_rng(b * d)
        planes = rng.random((b, d), dtype=np.float32)
        prev = rng.random(d, dtype=np.float32)
        want = np.asarray(jax_scene_scores(jnp.asarray(prev), jnp.asarray(planes),
                                           use_pallas=use_pallas))
        got = scene_scores(torch.from_numpy(prev), torch.from_numpy(planes))
        assert got.shape == (b,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)

    def test_wrapper_rejects_bad_input(self):
        with pytest.raises(ValueError):
            pair_diff(torch.zeros((1, 8)))
        with pytest.raises(TypeError):
            pair_diff(torch.zeros((3, 8), dtype=torch.float64))


def _nms_workload(b, k, n_classes=3, seed=0, pad_from=None):
    """The candidates of tests/test_nms_kernel.py: dense overlaps, sorted
    scores, an optional zero-score padding tail."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (b, k, 2))
    wh = rng.uniform(5, 40, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.1, 1.0, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    if pad_from is not None:
        scores[:, pad_from:] = 0.0
    classes = rng.integers(0, n_classes, (b, k)).astype(np.int32)
    return boxes, scores, classes


class TestNmsKeepMask:
    # the keep mask is a discrete output: it must be EXACTLY equal
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("k,pad_from", [(256, 200), (512, None), (100, None)])
    def test_plain_equals_jax(self, seed, k, pad_from):
        boxes, scores, classes = _nms_workload(2, k, seed=seed, pad_from=pad_from)
        got = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), 0.45).numpy()
        pallas = np.asarray(jax_nms_keep_mask(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.45,
            force_pallas=True))
        fixed = np.asarray(jax.vmap(
            lambda b, s, c: jax_nms_fixed(b, s, c, 0.45, k)["valid"])(
                jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes)))
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, fixed)
        if pad_from is not None:
            assert not got[:, pad_from:].any()  # padding never kept

    def test_greedy_semantics_by_hand(self):
        # 0 suppresses 1 (IoU 0.54); 1 would suppress 2 (IoU 0.54) but is
        # gone, and 2 overlaps 0 only by 0.25, so 2 stays; 3 is 0's twin in
        # another class; 4 is padding
        boxes = torch.tensor([[[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10],
                               [0, 0, 10, 10], [0, 0, 10, 10]]], dtype=torch.float32)
        scores = torch.tensor([[0.9, 0.8, 0.7, 0.6, 0.0]])
        classes = torch.tensor([[1, 1, 1, 2, 1]], dtype=torch.int32)
        keep = nms_keep_mask_plain(boxes, scores, classes, 0.45)
        assert keep.tolist() == [[True, False, True, True, False]]
