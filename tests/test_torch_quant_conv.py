"""The port's int8 convolutions (ops/quant.py's conv half, YOLOv8's `int8`
option) against the JAX package, on the CPU.

The weights quantize bit-equal from the same fp32 tree; one conv's int8
activations, scales and int32 sums equal the JAX package's, at stride 1 and
2 and with dilation. Through a whole YOLOv8n the two packages' fp32 SiLUs
differ by an ulp now and then, which rounds an int8 activation on a .5
boundary one step apart (hazard r) and then compounds through the 67
quantizations of a forward (63 convs, four of them in two parts). So the
model, the tasks and the pass are compared teacher-forced: the JAX run
records every quantization's int8 activations and scales, and the port's
run takes them in the same order. Where its own activations differ from the
JAX package's, each must differ by one step at a .5 boundary (within
ROUND_TOL of it); the port's own inputs to each quantization agree with the
JAX package's (X_RTOL), its logits too, and its rows equal the JAX rows at
fp32 (hazard b).
"""
import contextlib
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eioku_tpu.ml.detection as jax_detection
import eioku_tpu.ops.quant as jax_quant
from eioku_tpu.models.yolo.model import YoloConfig as JaxYoloConfig
from eioku_tpu.models.yolo.model import fold_batchnorm as jax_fold_batchnorm
from eioku_tpu.models.yolo.model import init_yolo_params, yolo_forward
from eioku_tpu.models.yolo.postprocess import detect as jax_detect
import eioku_tpu_torch.ops.quant as port_quant
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.layers import QuantConv2d, quantize_convs
from eioku_tpu_torch.models.yolo.model import YoloConfig, fold_batchnorm
from eioku_tpu_torch.models.yolo.weights import from_jax_params
from test_torch_slice import _match_rows, detector_clip, visual_cache_dir  # noqa: F401

ROUND_TOL = 1e-3  # |x / sx - (k + 0.5)| of an activation that rounds apart
X_RTOL = 1e-5  # the port's own quantization inputs, relative to their max |x|
LOGIT_TOL = 1e-5  # teacher-forced logits, relative to the largest |logit|
ROW_MATCH = 0.98  # as tests/test_torch_slice.py


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(3, 3, 3, 16), (1, 1, 40, 24), (3, 3, 64, 80)])
def test_quantize_conv_bit_equal(shape):
    w = _rng(1).normal(0, 0.3, shape).astype(np.float32)  # HWIO
    w[..., 0] = 0.0  # an all-zero output channel keeps a finite scale
    want = jax_quant.quantize_conv({"w": jnp.asarray(w), "b": jnp.zeros(shape[-1])})
    w_q, w_s = port_quant.quantize_conv(torch.from_numpy(np.transpose(w, (3, 2, 0, 1))))
    np.testing.assert_array_equal(np.transpose(w_q, (2, 3, 1, 0)), np.asarray(want["w_q"]))
    np.testing.assert_array_equal(w_s, np.asarray(want["w_s"]))
    assert w_q.dtype == np.int8 and w_s.dtype == np.float32


def _conv_case(k, c_in, c_out, seed):
    w = _rng(seed).normal(0, 0.2, (k, k, c_in, c_out)).astype(np.float32)
    b = _rng(seed + 1).normal(0, 0.1, c_out).astype(np.float32)
    p = jax_quant.quantize_conv({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    w_q = torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(p["w_q"]), (3, 2, 0, 1))))
    return p, w_q, torch.from_numpy(np.array(p["w_s"])), torch.from_numpy(b)


@pytest.mark.parametrize("k,stride,dilation,hw", [
    (3, 1, 1, (20, 24)), (3, 2, 1, (21, 24)), (3, 1, 2, (20, 17)), (1, 1, 1, (12, 16)),
    (5, 2, 1, (19, 22))])
def test_conv2d_q_matches_jax(k, stride, dilation, hw):
    c_in, c_out = 13, 24
    p, w_q, w_s, b = _conv_case(k, c_in, c_out, seed=k + stride + dilation)
    x = _rng(3).normal(0, 1.0, (2, *hw, c_in)).astype(np.float32)
    x[1] *= 4.0  # a per-image scale of its own
    xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)))
    # int8 activations and scales
    jxq, jsx = jax_quant._quant_act(jnp.asarray(x), axes=(1, 2, 3))
    xq, sx = port_quant.quant_act(xt, dims=(1, 2, 3))
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy().ravel(), np.asarray(jsx).ravel())
    # the int32 sums
    pad = dilation * (k - 1) // 2
    jacc = jax.lax.conv_general_dilated(
        jxq, p["w_q"], window_strides=(stride, stride), padding=[(pad, pad)] * 2,
        rhs_dilation=(dilation, dilation), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    acc = port_quant.conv_int32(xq, w_q, stride, dilation)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), np.asarray(jacc))
    # dequantized, cast and biased
    want = np.asarray(jax_quant.conv2d_q(jnp.asarray(x), p, stride=stride,
                                         dilation=dilation))
    got = port_quant.conv2d_q(xt, w_q, w_s, b, stride, dilation)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    module = QuantConv2d(w_q, w_s, b, stride, dilation)
    np.testing.assert_array_equal(module(xt).numpy(), got.numpy())


@pytest.mark.parametrize("per_group", [1, 2])
def test_conv2d_q_image_groups_match_jax(monkeypatch, per_group):
    """ACC_GROUP_BYTES cut to one or two images' int32 sums: the groups
    (2, 2, 1 of 5 images) give the JAX package's values for the batch, bit
    for bit, through the conv and through its 1x1 slices."""
    c_in, c_out, hw = 13, 24, (20, 24)
    p, w_q, w_s, b = _conv_case(3, c_in, c_out, seed=6)
    x = _rng(7).normal(0, 1.0, (5, *hw, c_in)).astype(np.float32)
    x *= np.array([1.0, 4.0, 0.5, 2.0, 8.0], np.float32)[:, None, None, None]
    monkeypatch.setattr(port_quant, "ACC_GROUP_BYTES", per_group * 10 * 12 * c_out * 4)
    want = np.asarray(jax_quant.conv2d_q(jnp.asarray(x), p, stride=2))
    got = port_quant.conv2d_q(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))),
                              w_q, w_s, b, stride=2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    p1, w1, s1, _ = _conv_case(1, 40, 32, seed=9)
    y = _rng(8).normal(0, 2.0, (5, 9, 11, 24)).astype(np.float32)
    monkeypatch.setattr(port_quant, "ACC_GROUP_BYTES", per_group * 9 * 11 * 32 * 4)
    want = np.asarray(jax_quant.conv2d_q_sliced(jnp.asarray(y), p1, 16, 40))
    got = port_quant.conv2d_q_sliced(torch.from_numpy(np.transpose(y, (0, 3, 1, 2))),
                                     w1, s1, 16, 40)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_conv2d_q_sliced_matches_jax():
    p, w_q, w_s, b = _conv_case(1, 40, 32, seed=9)
    x = _rng(4).normal(0, 2.0, (3, 9, 11, 24)).astype(np.float32)
    want = np.asarray(jax_quant.conv2d_q_sliced(jnp.asarray(x), p, 16, 40))
    got = port_quant.conv2d_q_sliced(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))),
                                     w_q, w_s, 16, 40)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # the module's per-part form: two parts each quantized apart, summed,
    # then the bias, as the JAX neck's _c2f_concat_in
    y = _rng(5).normal(0, 0.5, (3, 9, 11, 16)).astype(np.float32)
    want = np.asarray(jax_quant.conv2d_q_sliced(jnp.asarray(y), p, 0, 16)) + want + b.numpy()
    parts = torch.from_numpy(np.transpose(np.concatenate([y, x], -1), (0, 3, 1, 2)))
    got = QuantConv2d(w_q, w_s, b).forward_parts(parts, (16, 24))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


# -- teacher forcing: the JAX run's quantizations fed to the port's run ----------


class Recorded:
    """The JAX package's quantizations in call order: (x, xq, sx), NHWC."""

    def __init__(self):
        self.calls: list[tuple] = []
        self.at = 0


@contextlib.contextmanager
def record_jax_quantizations(keep_x: bool = False):
    """Record every `_quant_act` of the JAX package's convs, inside jit too
    (ordered debug callbacks), with the jit caches cleared around it so the
    patched function is traced."""
    rec = Recorded()
    orig = jax_quant._quant_act

    def host(x, xq, sx):
        rec.calls.append((np.asarray(x) if keep_x else None, np.asarray(xq),
                          np.asarray(sx)))

    def recording(x, axes):
        xq, sx = orig(x, axes)
        jax.debug.callback(host, x if keep_x else sx, xq, sx, ordered=True)
        return xq, sx

    jax.clear_caches()
    jax_quant._quant_act = recording
    try:
        yield rec
    finally:
        jax_quant._quant_act = orig
        jax.clear_caches()


def _nchw(a: np.ndarray, shape) -> np.ndarray:
    """A recorded NHWC array as the port's NCHW tensor of `shape`: a part
    that the JAX neck quantized before its 2x nearest upsample is upsampled
    here (nearest upsampling keeps the values and the maximum)."""
    a = np.transpose(a, (0, 3, 1, 2))
    while a.shape[2] < shape[2]:
        a = a.repeat(2, axis=2).repeat(2, axis=3)
    assert a.shape == tuple(shape), (a.shape, tuple(shape))
    return np.array(a)  # a writable copy for torch.from_numpy


@contextlib.contextmanager
def port_takes_recorded(rec: Recorded, stats: dict):
    """Patch the port's `quant_act` (convs only: 4-D inputs) to check its own
    quantization against the next recorded one, then return the recorded
    int8 activations and scales. stats collects the number of activations
    compared, the number that round apart, and the largest relative error of
    the port's own inputs (where the JAX inputs were recorded)."""
    orig = port_quant.quant_act
    stats.update(compared=0, apart=0, x_err=0.0)

    def forcing(x, dims=-1):
        if x.dim() != 4:
            return orig(x, dims)
        jx, jxq, jsx = rec.calls[rec.at]
        rec.at += 1
        jxq = torch.from_numpy(_nchw(jxq, x.shape))
        jsx = torch.from_numpy(np.array(jsx, np.float32).reshape(-1, 1, 1, 1))
        xq, sx = orig(x, dims)
        diff = xq.int() - jxq.int()
        apart = diff != 0
        stats["compared"] += diff.numel()
        stats["apart"] += int(apart.sum())
        if bool(apart.any()):
            assert int(diff.abs().max()) == 1
            t = (x.float() / sx)[apart]
            assert float((t - torch.floor(t) - 0.5).abs().max()) <= ROUND_TOL
        if jx is not None:
            ref = torch.from_numpy(_nchw(jx, x.shape))
            err = float((x.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
            stats["x_err"] = max(stats["x_err"], err)
        return jxq.to(torch.int8), jsx

    port_quant.quant_act = forcing
    try:
        yield
    finally:
        port_quant.quant_act = orig


@lru_cache(maxsize=None)
def _jax_tree():
    return init_yolo_params(JaxYoloConfig("yolov8n"), seed=0)


def test_yolo_int8_forward_matches_jax():
    tree = _jax_tree()
    jtree = jax_quant.quantize_convs(jax_fold_batchnorm(tree))
    model = fold_batchnorm(from_jax_params(tree, YoloConfig("yolov8n"))).eval()
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    quantize_convs(model)
    assert sum(isinstance(m, QuantConv2d) for m in model.modules()) == n_convs
    assert not any(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    img = _rng(7).random((2, 96, 128, 3), dtype=np.float32)
    fwd = jax.jit(yolo_forward, static_argnames=("cfg",))
    with record_jax_quantizations(keep_x=True) as rec:
        jb, jc = fwd(jtree, jnp.asarray(img), cfg=JaxYoloConfig("yolov8n"))
        jax.effects_barrier()
    # every conv, and the four neck C2fs' cv1 once more (two parts each)
    assert len(rec.calls) == n_convs + 4
    stats = {}
    with port_takes_recorded(rec, stats), torch.no_grad():
        tb, tc = model(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert rec.at == len(rec.calls)
    assert stats["apart"] <= 1e-3 * stats["compared"], stats
    assert stats["x_err"] <= X_RTOL, stats
    for got, want in ((tb, jb), (tc, jc)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= LOGIT_TOL, err


# -- the int8 tasks --------------------------------------------------------------


def _jax_detect_fp32(params, images, cfg, **kw):
    """The JAX detect without the bf16 cast of its uint8 path (hazard b)."""
    images = jnp.asarray(images)
    if images.dtype == jnp.uint8:
        images = images.astype(jnp.float32) / 255.0
    return jax_detect(params, images, cfg, **kw)


def assert_int8_rows_match(want, got, stats):
    assert len(want) > 0
    assert stats["compared"] > 0 and stats["apart"] <= 1e-3 * stats["compared"], stats
    matched = _match_rows(want, got)
    assert matched >= ROW_MATCH * max(len(want), len(got)), (matched, len(want), len(got))


@pytest.fixture()
def jax_task_at_fp32(monkeypatch):
    monkeypatch.setattr(jax_detection, "detect", _jax_detect_fp32)


@pytest.mark.parametrize("task", ["object_detection", "face_detection"])
def test_int8_task_matches_jax(task, detector_clip, visual_cache_dir, jax_task_at_fp32):
    """The int8 tasks (the port refused them before) against the JAX
    package's, teacher-forced; faces at the random-weight threshold."""
    run_jax = {"object_detection": jax_detection.run_object_detection,
               "face_detection": jax_detection.run_face_detection}[task]
    # one device: the JAX task's "auto" would shard over conftest's 8 host
    # devices, where ordered callbacks are refused
    config = {"batch_size": 4, "decode_fast": 0, "int8": True, "data_parallel": False}
    if task == "face_detection":
        config.update(confidence_threshold=0.2, frame_interval_s=1.0)
    with record_jax_quantizations() as rec:
        want = run_jax(detector_clip, config, visual_cache_dir)
    stats = {}
    with port_takes_recorded(rec, stats):
        got = InferenceEngine(model_cache_dir=visual_cache_dir, device="cpu").run_task(
            task, detector_clip, config)
    assert rec.at == len(rec.calls) > 0
    assert_int8_rows_match(want, got, stats)


def test_int8_options_cached_apart(visual_cache_dir):
    from eioku_tpu_torch.ml.detection import _load_model

    dev = torch.device("cpu")
    plain = _load_model("yolov8n", 80, visual_cache_dir, dev)
    int8 = _load_model("yolov8n", 80, visual_cache_dir, dev, True)
    assert plain is not int8
    assert not any(isinstance(m, QuantConv2d) for m in plain.modules())
    convs = [m for m in int8.modules() if isinstance(m, QuantConv2d)]
    assert convs and all(m.w_s.dtype == torch.float32 and m.w_q.dtype == torch.int8
                         for m in convs)
    assert int8.dtype == torch.float32
    # the card's compute type: biases follow it, the scales stay fp32 (the
    # JAX package keeps w_s fp32 and casts b to the activations' type)
    half = quantize_convs(fold_batchnorm(from_jax_params(_jax_tree(), YoloConfig("yolov8n"))))
    half = half.to(torch.bfloat16)
    assert half.dtype == torch.bfloat16
    for m in half.modules():
        if isinstance(m, QuantConv2d):
            assert m.w_s.dtype == torch.float32 and m.w_q.dtype == torch.int8
            assert m.bias.dtype == torch.bfloat16

