"""PyTorch port's YOLOv8 (eioku_tpu_torch.models.yolo) against the JAX package.

Weights come from the JAX package's seeded `init_yolo_params` and are carried
over two ways (the JAX tree directly, and through an ultralytics state dict).
Images are seeded numpy floats; both sides run fp32 on the CPU (JAX's detect
stays fp32 when handed float images).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eioku_tpu.models.yolo.model import YoloConfig as JaxYoloConfig
from eioku_tpu.models.yolo.model import anchor_points as jax_anchor_points
from eioku_tpu.models.yolo.model import fold_batchnorm as jax_fold_batchnorm
from eioku_tpu.models.yolo.model import init_yolo_params, yolo_forward
from eioku_tpu.models.yolo.postprocess import decode_boxes as jax_decode_boxes
from eioku_tpu.models.yolo.postprocess import detect as jax_detect
from eioku_tpu.models.yolo.weights import export_ultralytics_state_dict
from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
from eioku_tpu_torch.models.yolo.model import (
    YOLOv8,
    YoloConfig,
    anchor_points,
    fold_batchnorm,
)
from eioku_tpu_torch.models.yolo.postprocess import decode_boxes, detect
from eioku_tpu_torch.models.yolo.weights import (
    from_jax_params,
    load_ultralytics_state_dict,
)

# fp32 convolutions summed in another order through ~20 layers
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-3


@lru_cache(maxsize=None)
def _jax_tree(variant):
    # one seeded tree per variant, shared by the tests (JAX init is slow on
    # the CPU); each test builds its own port module from it
    return init_yolo_params(JaxYoloConfig(variant), seed=0)


def _port_and_jax(variant):
    tree = _jax_tree(variant)
    return from_jax_params(tree, YoloConfig(variant)).eval(), tree


def _images(b, h, w, seed=0):
    return np.random.default_rng(seed).random((b, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("variant", ["yolov8n", "yolov8s"])
def test_weight_loaders_agree(variant):
    tree = _jax_tree(variant)
    a = from_jax_params(tree, YoloConfig(variant)).state_dict()
    b = load_ultralytics_state_dict(
        export_ultralytics_state_dict(tree, JaxYoloConfig(variant)),
        YoloConfig(variant)).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_loader_rejects_a_mismatched_variant():
    tree = _jax_tree("yolov8n")
    with pytest.raises((KeyError, RuntimeError)):
        from_jax_params(tree, YoloConfig("yolov8s"))


@pytest.mark.parametrize("variant", ["yolov8n", "yolov8s"])
@pytest.mark.parametrize("hw", [(64, 64), (96, 160)])
def test_logits_match_jax(variant, hw):
    model, tree = _port_and_jax(variant)
    img = _images(2, *hw)
    jb, jc = yolo_forward(tree, jnp.asarray(img), JaxYoloConfig(variant))
    with torch.no_grad():
        tb, tc = model(torch.from_numpy(img).permute(0, 3, 1, 2))
    anchors = sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))
    assert tb.shape == (2, anchors, 64) and tc.shape == (2, anchors, 80)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)


def test_fold_batchnorm_keeps_the_function():
    model, _ = _port_and_jax("yolov8n")
    # non-trivial batch-norm statistics so the fold has work to do
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    x = torch.from_numpy(_images(1, 64, 96)).permute(0, 3, 1, 2)
    with torch.no_grad():
        before = model(x)
        after = fold_batchnorm(model)(x)
    for a, b in zip(before, after):
        torch.testing.assert_close(b, a, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_random_init_is_seeded():
    a = YOLOv8(YoloConfig("yolov8n"), generator=torch.Generator().manual_seed(7))
    b = YOLOv8(YoloConfig("yolov8n"), generator=torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert len(COCO_CLASSES) == a.cfg.num_classes


@pytest.mark.parametrize("hw", [(96, 160), (40, 72)])
def test_anchors_and_decode_match_jax(hw):
    ja, js = jax_anchor_points(*hw, (8, 16, 32))
    ta, ts = anchor_points(*hw, (8, 16, 32))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    logits = np.random.default_rng(1).normal(0, 2, (2, ta.shape[0], 64)) \
        .astype(np.float32)
    want = jax_decode_boxes(jnp.asarray(logits), ja, js, 16)
    got = decode_boxes(torch.from_numpy(logits), ta, ts, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


# (top_k, max_det): the default route keeps score-ordered slots; the
# K > max_det route truncates kept-first. (80, 120) is not stride-aligned,
# so detect() pads on the device.
@pytest.mark.parametrize("top_k,max_det,hw", [(256, 300, (96, 160)),
                                              (512, 10, (96, 160)),
                                              (256, 300, (80, 120))])
def test_detect_matches_jax(top_k, max_det, hw):
    model, tree = _port_and_jax("yolov8n")
    fold_batchnorm(model)
    img = _images(2, *hw, seed=5)
    want = jax_detect(jax_fold_batchnorm(tree), jnp.asarray(img),
                      JaxYoloConfig("yolov8n"), conf_threshold=0.25,
                      top_k=top_k, max_det=max_det)
    got = detect(model, torch.from_numpy(img), conf_threshold=0.25,
                 top_k=top_k, max_det=max_det)
    anchors = sum((-(-hw[0] // 32) * 32 // s) * (-(-hw[1] // 32) * 32 // s)
                  for s in (8, 16, 32))
    assert got["boxes"].shape == (2, min(top_k, anchors, max_det), 4)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    # scores are sigmoids of logits that agree to ~1e-6; boxes are
    # DFL expectations scaled by strides up to 32 px
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=0, atol=1e-3)
    assert got["valid"].any()


def test_detect_accepts_uint8_images():
    model, tree = _port_and_jax("yolov8n")
    fold_batchnorm(model)
    img = np.random.default_rng(9).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    got = detect(model, torch.from_numpy(img), conf_threshold=0.0)
    want = detect(model, torch.from_numpy(img.astype(np.float32) / 255.0),
                  conf_threshold=0.0)
    for k in got:
        torch.testing.assert_close(got[k], want[k])
