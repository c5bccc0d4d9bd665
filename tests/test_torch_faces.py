"""The PyTorch port's face path (yolov8n-face, ArcFace iresnet18, IoU
tracking, the face_detection task) against the JAX package, on the CPU at
fp32.

Weights come from the JAX package's seeded trees and are written once into a
model cache that both packages load: `yolov8n-face.pt` (ultralytics layout,
one class) and `arcface_r18.pth` (insightface layout).
"""
import copy
from functools import lru_cache

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eioku_tpu.ml import detection as jax_detection
from eioku_tpu.ml.face_tracking import FaceTracker as JaxFaceTracker
from eioku_tpu.models.face_embed.model import face_embed, init_face_embed_params
from eioku_tpu.models.face_embed.model import preprocess as jax_face_preprocess
from eioku_tpu.models.yolo.model import YoloConfig as JaxYoloConfig
from eioku_tpu.models.yolo.model import fold_batchnorm as jax_fold_batchnorm
from eioku_tpu.models.yolo.model import init_yolo_params
from eioku_tpu.models.yolo.postprocess import detect as jax_detect
from eioku_tpu.models.yolo.weights import export_ultralytics_state_dict
from eioku_tpu_torch.ml import detection
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.ml.face_tracking import FaceTracker
from eioku_tpu_torch.models.face_embed.model import (
    EMBED_DIM,
    IResNet18,
    from_jax_params,
    load_arcface_state_dict,
    load_face_embed,
    preprocess,
)
from eioku_tpu_torch.models.yolo.model import YoloConfig, fold_batchnorm
from eioku_tpu_torch.models.yolo.postprocess import detect
from eioku_tpu_torch.models.yolo.weights import from_jax_params as yolo_from_jax_params
from eioku_tpu_torch.models.yolo.weights import load_ultralytics_state_dict
# face rows: >= 98% matched by frame, box within 2 px and confidence within
# 0.02; cluster ids equal and embedding cosine >= 0.9999 on matched rows
from test_torch_slice import FACE_CONF, _jax_detect_fp32, assert_face_rows_match

# fp32 embeddings through 18 layers and a 25088-wide fc: measured 1.2e-3 at
# |value| ~360 (3.4e-6 relative)
EMBED_RTOL = 2e-5


@lru_cache(maxsize=None)
def _arcface_tree():
    return init_face_embed_params(seed=0)


@lru_cache(maxsize=None)
def _face_yolo_tree():
    return init_yolo_params(JaxYoloConfig("yolov8n", num_classes=1), seed=0)


def insightface_state_dict(tree) -> dict:
    """The JAX tree in insightface arcface_torch's iresnet18 layout, written
    out key by key (independent of the port's converter)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def cw(w):
        return t(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1))))

    def bn(prefix, p, sd):
        for ours, theirs in (("gamma", "weight"), ("beta", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.{theirs}"] = t(p[ours])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    sd = {"conv1.weight": cw(tree["conv1"]["w"]), "prelu.weight": t(tree["prelu"]),
          "fc.weight": t(np.asarray(tree["fc"]["w"]).T), "fc.bias": t(tree["fc"]["b"])}
    for name in ("bn1", "bn2", "features"):
        bn(name, tree[name], sd)
    for si, stage in enumerate(tree["layers"]):
        for bi, blk in enumerate(stage):
            base = f"layer{si + 1}.{bi}"
            sd[f"{base}.conv1.weight"] = cw(blk["conv1"]["w"])
            sd[f"{base}.conv2.weight"] = cw(blk["conv2"]["w"])
            sd[f"{base}.prelu.weight"] = t(blk["prelu"])
            for n in ("1", "2", "3"):
                bn(f"{base}.bn{n}", blk[f"bn{n}"], sd)
            if "down" in blk:
                sd[f"{base}.downsample.0.weight"] = cw(blk["down"]["w"])
                bn(f"{base}.downsample.1", blk["down"]["bn"], sd)
    return sd


@pytest.fixture(scope="module")
def face_cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_faces_models")
    sd = export_ultralytics_state_dict(_face_yolo_tree(),
                                       JaxYoloConfig("yolov8n", num_classes=1))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(d / "yolov8n-face.pt"))
    torch.save(insightface_state_dict(_arcface_tree()), str(d / "arcface_r18.pth"))
    return str(d)


@pytest.fixture(scope="module")
def face_clip(tmp_path_factory):
    """7 s at 10 fps, 320x180: faces sample frames 0, 30 and 60."""
    path = str(tmp_path_factory.mktemp("torch_faces") / "faces.mp4")
    write_block_clip(path, 70, (320, 180))
    return path


def write_block_clip(path, n_frames, size, fps=10):
    """Frames of random 20x20-pixel colour blocks: with random weights every
    face candidate scores within ~0.01 of 0.5, and texture spreads those
    scores apart (fp32 summation order then cannot reorder near-ties)."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert w.isOpened()
    rng = np.random.default_rng(0)
    for _ in range(n_frames):
        small = rng.integers(0, 256, (size[1] // 20, size[0] // 20, 3)).astype(np.uint8)
        w.write(cv2.resize(small, size, interpolation=cv2.INTER_NEAREST))
    w.release()


# -- ArcFace ---------------------------------------------------------------------


def test_embeddings_match_jax():
    tree = _arcface_tree()
    model = from_jax_params(tree).eval()
    x = np.random.default_rng(1).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    want = np.asarray(face_embed(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, EMBED_DIM)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_RTOL * scale)


def test_from_jax_params_equals_state_dict_load():
    a = from_jax_params(_arcface_tree()).state_dict()
    b = load_arcface_state_dict(insightface_state_dict(_arcface_tree())).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["arcface_r18.pth", "arcface_r18/backbone.pth",
                                  "backbone.pth"])
def test_load_face_embed_checkpoint_names(name, tmp_path):
    path = tmp_path / name
    path.parent.mkdir(exist_ok=True)
    # a DataParallel checkpoint's 'module.' prefix is accepted too
    torch.save({f"module.{k}": v for k, v in
                insightface_state_dict(_arcface_tree()).items()}, str(path))
    model, pretrained = load_face_embed(str(tmp_path))
    assert pretrained
    want = from_jax_params(_arcface_tree()).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_random_init_is_seeded():
    a, pretrained = load_face_embed(None, seed=2)
    b, _ = load_face_embed(None, seed=2)
    assert not pretrained and isinstance(a, IResNet18)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.all(a.prelu.weight == 0.25)


def test_preprocess_matches_jax():
    crops = np.random.default_rng(3).integers(0, 256, (3, 112, 112, 3), dtype=np.uint8)
    np.testing.assert_array_equal(preprocess(crops), jax_face_preprocess(crops))


# -- yolov8n-face ----------------------------------------------------------------


def test_face_yolo_loaders_agree():
    tree = _face_yolo_tree()
    a = yolo_from_jax_params(tree, YoloConfig("yolov8n", num_classes=1)).state_dict()
    b = load_ultralytics_state_dict(
        export_ultralytics_state_dict(tree, JaxYoloConfig("yolov8n", num_classes=1)),
        YoloConfig("yolov8n", num_classes=1)).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["head_cls.0.2.weight"].shape[0] == 1


def test_face_detect_matches_jax():
    # one class: every candidate pair is IoU-tested in the NMS
    tree = _face_yolo_tree()
    model = fold_batchnorm(yolo_from_jax_params(tree, YoloConfig("yolov8n", num_classes=1)))
    img = np.random.default_rng(5).random((2, 96, 160, 3), dtype=np.float32)
    want = jax_detect(jax_fold_batchnorm(tree), jnp.asarray(img),
                      JaxYoloConfig("yolov8n", num_classes=1), conf_threshold=FACE_CONF)
    got = detect(model.eval(), torch.from_numpy(img), conf_threshold=FACE_CONF)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=0, atol=1e-3)
    assert int(got["valid"].sum()) > 2


# -- tracking --------------------------------------------------------------------


def _box_sequence(seed, n_frames=12):
    """Per frame a list of boxes: a few tracks drifting with jitter, some
    missing in some frames, plus a stray box now and then."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 400, (4, 2))
    frames = []
    for f in range(n_frames):
        boxes = []
        for t, (x, y) in enumerate(starts):
            if rng.random() < 0.25:
                continue
            boxes.append({"x": float(x + 6 * f + rng.normal(0, 2)),
                          "y": float(y + rng.normal(0, 2)),
                          "width": float(50 + 5 * t), "height": float(60 + 3 * t)})
        if rng.random() < 0.3:
            boxes.append({"x": float(rng.uniform(0, 500)), "y": float(rng.uniform(0, 300)),
                          "width": 40.0, "height": 40.0})
        frames.append(boxes)
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_index", [True, False])
def test_face_tracker_ids_match_jax(seed, with_index):
    mine, theirs = FaceTracker(frame_step=30), JaxFaceTracker(frame_step=30)
    # gaps of several samples expire tracks when frame indices are given
    frame_numbers = [0, 30, 60, 90, 240, 270, 300, 330, 360, 600, 630, 660]
    for fn, boxes in zip(frame_numbers, _box_sequence(seed)):
        kw = {"frame_index": fn} if with_index else {}
        assert mine.assign(boxes, **kw) == theirs.assign(boxes, **kw)


def test_assign_face_clusters_matches_jax():
    rows = [{"payload": {"cluster_id": None, "confidence": 0.5, "bounding_box": b,
                         "frame_number": 90 * i}}
            for i, boxes in enumerate(_box_sequence(7)) for b in boxes]
    mine, theirs = copy.deepcopy(rows), copy.deepcopy(rows)
    detection._assign_face_clusters(mine)  # frame step estimated: 90
    jax_detection._assign_face_clusters(theirs)
    assert [r["payload"]["cluster_id"] for r in mine] == \
        [r["payload"]["cluster_id"] for r in theirs]
    assert len({r["payload"]["cluster_id"] for r in mine}) > 3


# -- the face_detection task -----------------------------------------------------


def test_face_detection_task_matches_jax(face_clip, face_cache, monkeypatch):
    # the JAX task detects in bf16 (detect's uint8 path) and, with the
    # tests' 8 virtual devices, data-parallel: hold it to one device at fp32
    monkeypatch.setattr(jax_detection, "detect", _jax_detect_fp32)
    config = {"embeddings": True, "confidence_threshold": FACE_CONF,
              "batch_size": 4, "decode_fast": 0, "data_parallel": False}
    want = jax_detection.run_face_detection(face_clip, config, face_cache)
    got = InferenceEngine(model_cache_dir=face_cache, device="cpu").run_task(
        "face_detection", face_clip, config)
    assert {r["payload"]["frame_number"] for r in got} <= {0, 30, 60}
    assert all(r["span_end_ms"] - r["span_start_ms"] == 100 for r in got)
    assert_face_rows_match(want, got)


def test_attach_face_embeddings_matches_jax(face_clip, face_cache):
    # the combined pass's post-hoc path: re-decode on the true grid, crop,
    # embed; the same rows go through both packages
    rows = InferenceEngine(model_cache_dir=face_cache, device="cpu").run_task(
        "face_detection", face_clip, {"confidence_threshold": FACE_CONF,
                                      "batch_size": 4, "decode_fast": 0})
    assert len(rows) > 20
    assert rows and all("embedding" not in r["payload"] for r in rows)
    mine, theirs = copy.deepcopy(rows), copy.deepcopy(rows)
    detection.attach_face_embeddings(face_clip, mine, 30, face_cache, "cpu")
    jax_detection.attach_face_embeddings(face_clip, theirs, 30, face_cache)
    assert_face_rows_match(theirs, mine)
