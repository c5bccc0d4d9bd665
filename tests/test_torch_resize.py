"""The port's device letterbox (ops/resize.py, `preprocess: "device"`)
against the JAX package's, on the CPU at fp32.

The interpolation matrices are built by the same numpy code and must be
equal; the two einsum products sum the same two nonzero taps per output,
so resize and letterbox agree within RESIZE_TOL. The object_detection and
face_detection tasks with the device letterbox are held to the JAX tasks'
rows (the JAX device route runs its detector in fp32, as the port does on
the CPU).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eioku_tpu.ml.detection as jax_detection
from eioku_tpu.ops import resize as jax_resize
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.ops import resize
from test_torch_faces import face_cache, face_clip  # noqa: F401
from test_torch_slice import (  # noqa: F401
    FACE_CONF,
    ROW_MATCH,
    _match_rows,
    assert_face_rows_match,
    detector_clip,
    yolo_cache_dir,
)

RESIZE_TOL = 1e-6  # relative to the value range (uint8 values, or [0, 1])

# (H, W) -> (out_h, out_w): odd sizes, up and down, other aspect ratios
_SIZES = [((37, 53), (20, 29)), ((9, 7), (16, 23)), ((50, 50), (50, 50)),
          ((31, 80), (13, 33)), ((5, 96), (7, 64))]


@pytest.mark.parametrize("n_in,n_out", [(37, 20), (9, 16), (50, 50), (1, 5), (640, 333)])
def test_interp_matrices_equal(n_in, n_out):
    got = resize._interp_matrix(n_in, n_out)
    np.testing.assert_array_equal(got, jax_resize._interp_matrix(n_in, n_out))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,out", _SIZES)
def test_resize_matches_jax(hw, out):
    x = np.random.default_rng(sum(hw)).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), *out))
    got = resize.resize_bilinear(torch.from_numpy(x), *out)
    assert got.dtype == torch.float32 and got.shape == (2, *out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_TOL * 255)


@pytest.mark.parametrize("hw,size", [((37, 53), (64, 64)), ((360, 640), (640, 640)),
                                     ((97, 31), (96, 128)), ((720, 1280), (640, 640))])
def test_letterbox_matches_jax(hw, size):
    x = np.random.default_rng(hw[0]).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_resize.letterbox_resize_normalize(jnp.asarray(x), *size))
    got = resize.letterbox_resize_normalize(torch.from_numpy(x), *size)
    assert got.shape == (2, *size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_TOL)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert resize.letterbox_geometry(*hw, size[0]) == \
        jax_resize.letterbox_geometry(*hw, size[0])


def test_object_detection_device_letterbox_matches_jax(detector_clip, yolo_cache_dir):
    # the port refused preprocess "device" before
    config = {"batch_size": 4, "decode_fast": 0, "preprocess": "device"}
    want = jax_detection.run_object_detection(detector_clip, config, yolo_cache_dir)
    got = InferenceEngine(model_cache_dir=yolo_cache_dir, device="cpu").run_task(
        "object_detection", detector_clip, config)
    assert len(want) > 0
    assert _match_rows(want, got) >= ROW_MATCH * max(len(want), len(got))


def test_face_detection_device_letterbox_matches_jax(face_clip, face_cache):
    config = {"batch_size": 4, "decode_fast": 0, "preprocess": "device",
              "confidence_threshold": FACE_CONF}
    want = jax_detection.run_face_detection(face_clip, config, face_cache)
    got = InferenceEngine(model_cache_dir=face_cache, device="cpu").run_task(
        "face_detection", face_clip, config)
    assert_face_rows_match(want, got)
