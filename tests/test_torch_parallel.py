"""The port's data-parallel inference (parallel/inference.py) and the
detection task's `data_parallel` option, on the CPU.

A DataParallelDetector or DataParallelEmbedder over ["cpu", "cpu"] runs the
split, one share per entry and the gather; its outputs must equal the
plain path's: the same keep masks and classes, boxes and scores within a
few fp32 ulps (DET_RTOL). Batch sizes are uneven, so the padding is exercised.

Against the JAX package: its DataParallelDetector and DataParallelEmbedder
shard over conftest's host devices on a (data 4, model 2) mesh, as
tests/test_parallel.py builds it, and the port's run over ["cpu"] * k from
the same weights: keep masks and classes equal, scores and boxes within
tests/test_torch_yolo.py's JAX tolerances (JAX_SCORE_TOL, JAX_BOX_TOL),
embeddings within JAX_EMBED_TOL. The object_detection and face_detection
tasks with `data_parallel: true` run sharded over every host device in the
JAX package (its detect at fp32, hazard b) and over two CPU replicas in the
port; their rows are held to each other as tests/test_torch_slice.py holds
the tasks' rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eioku_tpu.ml.detection as jax_detection
import eioku_tpu.models.yolo.postprocess as jax_postprocess
from eioku_tpu.models.embed import minilm as jml
from eioku_tpu.models.yolo.model import YoloConfig as JaxYoloConfig
from eioku_tpu.models.yolo.model import fold_batchnorm as jax_fold_batchnorm
from eioku_tpu.parallel.inference import DataParallelDetector as JaxDataParallelDetector
from eioku_tpu.parallel.inference import DataParallelEmbedder as JaxDataParallelEmbedder
from eioku_tpu.parallel.inference import pad_to_multiple as jax_pad_to_multiple
from eioku_tpu.parallel.mesh import make_mesh
import eioku_tpu_torch.ml.detection as port_detection
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.embed import minilm as pml
from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, init_minilm, minilm_embed
from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
from eioku_tpu_torch.models.yolo.postprocess import detect
from eioku_tpu_torch.parallel.inference import (
    DataParallelDetector,
    DataParallelEmbedder,
    pad_to_multiple,
)
from test_torch_faces import face_cache, face_clip  # noqa: F401
from test_torch_slice import (  # noqa: F401
    FACE_CONF,
    ROW_MATCH,
    _jax_detect_fp32,
    _match_rows,
    assert_face_rows_match,
    detector_clip,
    yolo_cache_dir,
)
from test_torch_yolo import _port_and_jax

# boxes (pixels) and scores, shares against the whole batch: a few fp32
# ulps (CPU convolutions over another batch size sum in another order)
DET_RTOL, DET_TOL = 1e-6, 1e-5
EMBED_TOL = 1e-6  # unit vectors
# against the JAX package, as tests/test_torch_yolo.py's test_detect_matches_jax:
# sigmoids of logits that agree to ~1e-6; DFL boxes scaled by strides to 32 px
JAX_SCORE_TOL, JAX_BOX_TOL = 1e-5, 1e-3
JAX_EMBED_TOL = 1e-5  # unit vectors, fp32 layers summed in another order


@pytest.mark.parametrize("b,n", [(5, 2), (4, 2), (1, 3), (7, 4)])
def test_pad_to_multiple_matches_jax(b, n):
    x = np.arange(b * 6, dtype=np.int32).reshape(b, 2, 3)
    got, orig = pad_to_multiple(torch.from_numpy(x), n)
    want, jorig = jax_pad_to_multiple(jnp.asarray(x), n)
    assert orig == jorig == b
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def detector():
    model = YOLOv8(YoloConfig("yolov8n", num_classes=4),
                   generator=torch.Generator().manual_seed(0))
    return fold_batchnorm(model).eval()


@pytest.mark.parametrize("b,devices", [(3, 2), (5, 2), (2, 3)])
def test_dp_detector_equals_plain(detector, b, devices):
    frames = torch.from_numpy(np.random.default_rng(b).integers(
        0, 256, (b, 64, 96, 3), dtype=np.uint8))
    want = detect(detector, frames, conf_threshold=0.0, top_k=64)
    dp = DataParallelDetector(detector, ["cpu"] * devices)
    assert all(r is detector for r in dp.replicas)  # one device: one replica
    got = dp(frames, conf_threshold=0.0, top_k=64)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["classes"], want["classes"])
    for k in ("boxes", "scores"):
        torch.testing.assert_close(got[k], want[k], rtol=DET_RTOL, atol=DET_TOL)


@pytest.mark.parametrize("b", [5, 2, 1])
def test_dp_embedder_equals_plain(b):
    cfg = MiniLMConfig(vocab_size=128, dim=32, n_layers=1, n_heads=2, ffn_dim=64,
                       max_position=16)
    model = init_minilm(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(b)
    ids = torch.from_numpy(rng.integers(0, 128, (b, 16)).astype(np.int32))
    mask = torch.ones((b, 16), dtype=torch.int32)
    mask[0, 9:] = 0
    want = minilm_embed(model, ids, mask)
    got = DataParallelEmbedder(model, ["cpu", "cpu"])(ids, mask)
    assert got.shape == (b, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=EMBED_TOL)


@pytest.mark.parametrize("option", [True, "auto"])
def test_object_detection_data_parallel_equals_plain(detector_clip, yolo_cache_dir,
                                                     option):
    # true was refused before; on the CPU both run one replica, with "auto"
    # the plain path
    engine = InferenceEngine(model_cache_dir=yolo_cache_dir, device="cpu")
    config = {"batch_size": 4, "decode_fast": 0}
    plain = engine.run_task("object_detection", detector_clip,
                            {**config, "data_parallel": False})
    got = engine.run_task("object_detection", detector_clip,
                          {**config, "data_parallel": option})
    assert plain and got == plain


def test_data_parallel_devices_cover_every_card(monkeypatch):
    from eioku_tpu_torch.ml.detection import data_parallel_devices

    assert data_parallel_devices(torch.device("cpu")) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert data_parallel_devices(torch.device("cuda")) == \
        [torch.device("cuda", i) for i in range(3)]


# -- against the JAX package ------------------------------------------------------


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, model_parallel=2)  # data 4, model 2


@pytest.mark.parametrize("b,devices", [(5, 2), (3, 3)])
def test_dp_detector_matches_jax(mesh8, b, devices):
    """5 frames pad to 8 on the JAX data axis of 4 and to 6 over two port
    replicas; 3 frames to 4 and to 3."""
    model, tree = _port_and_jax("yolov8n")
    fold_batchnorm(model)
    img = np.random.default_rng(b).random((b, 64, 96, 3), dtype=np.float32)
    want = JaxDataParallelDetector(jax_fold_batchnorm(tree), JaxYoloConfig("yolov8n"),
                                   mesh8)(img, conf_threshold=0.25)
    got = DataParallelDetector(model, ["cpu"] * devices)(torch.from_numpy(img),
                                                         conf_threshold=0.25)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=JAX_SCORE_TOL)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=0, atol=JAX_BOX_TOL)
    assert got["valid"].any()


@pytest.mark.parametrize("b,devices", [(6, 2), (3, 4), (1, 3)])
def test_dp_embedder_matches_jax(mesh8, b, devices):
    kw = dict(vocab_size=128, dim=32, n_layers=1, n_heads=2, ffn_dim=64, max_position=16)
    tree = jml.init_minilm_params(jml.MiniLMConfig(**kw), seed=0)
    model = pml.load_state(pml.MiniLM(MiniLMConfig(**kw)),
                           pml.from_jax_params(jax.tree.map(np.asarray, tree)))
    rng = np.random.default_rng(b)
    ids = rng.integers(0, 128, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    mask[0, 9:] = 0
    want = np.asarray(JaxDataParallelEmbedder(tree, jml.MiniLMConfig(**kw), mesh8)(ids, mask))
    got = DataParallelEmbedder(model, ["cpu"] * devices)(torch.from_numpy(ids),
                                                         torch.from_numpy(mask))
    assert got.shape == want.shape == (b, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_EMBED_TOL)


def _count_calls(monkeypatch, cls) -> list:
    """The batch size of each call of cls's instances."""
    seen, call = [], cls.__call__

    def counted(self, frames, *a, **kw):
        seen.append(len(frames))
        return call(self, frames, *a, **kw)

    monkeypatch.setattr(cls, "__call__", counted)
    return seen


@pytest.fixture()
def dp_on_both(monkeypatch):
    """The JAX task's DataParallelDetector without detect's bf16 cast of
    uint8 frames (hazard b), and the port's over two CPU replicas; each
    task's cached detector is built anew, before and after."""
    monkeypatch.setattr(jax_postprocess, "detect", _jax_detect_fp32)
    monkeypatch.setattr(port_detection, "data_parallel_devices", lambda dev: [dev, dev])
    for cached in (jax_detection._dp_detector, port_detection._dp_detector):
        cached.cache_clear()
    yield (_count_calls(monkeypatch, JaxDataParallelDetector),
           _count_calls(monkeypatch, DataParallelDetector))
    for cached in (jax_detection._dp_detector, port_detection._dp_detector):
        cached.cache_clear()


@pytest.mark.parametrize("task", ["object_detection", "face_detection"])
def test_data_parallel_task_matches_jax(task, request, dp_on_both):
    """Batches of 3: 8 on the JAX package's 8 host devices, 4 over the
    port's two replicas."""
    jax_calls, port_calls = dp_on_both
    config = {"batch_size": 3, "decode_fast": 0, "data_parallel": True}
    if task == "object_detection":
        clip, cache = (request.getfixturevalue(f) for f in ("detector_clip", "yolo_cache_dir"))
        run_jax = jax_detection.run_object_detection
    else:
        clip, cache = (request.getfixturevalue(f) for f in ("face_clip", "face_cache"))
        run_jax = jax_detection.run_face_detection
        config["confidence_threshold"] = FACE_CONF
    want = run_jax(clip, config, cache)
    got = InferenceEngine(model_cache_dir=cache, device="cpu").run_task(task, clip, config)
    assert jax_calls and jax_calls == port_calls and set(port_calls) == {3}
    if task == "face_detection":
        assert_face_rows_match(want, got)
    else:
        assert len(want) > 0
        assert _match_rows(want, got) >= ROW_MATCH * max(len(want), len(got))
