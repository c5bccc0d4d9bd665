"""The PyTorch port's first slice end to end against the JAX package (CPU).

The combined visual pass (scenes + YOLOv8n objects) and standalone scene
detection run through both packages on the same synthetic clips; the port's
engine refuses what the slice does not cover; the port imports nothing of
JAX or of the JAX package.
"""
import ast
import pathlib
from functools import partial

import cv2
import numpy as np
import pytest
import torch

import jax

from eioku_tpu.ml import combined as jax_combined
from eioku_tpu.ml.combined import run_visual_analysis as jax_visual_analysis
from eioku_tpu.ml.scenes import detect_scenes as jax_detect_scenes
from eioku_tpu.models.yolo.model import YoloConfig as JaxYoloConfig
from eioku_tpu.models.yolo.model import init_yolo_params
from eioku_tpu.models.yolo.postprocess import detect as jax_detect
from eioku_tpu.models.yolo.weights import export_ultralytics_state_dict
from eioku_tpu.ops.colorspace import i420_to_rgb as jax_i420_to_rgb
from eioku_tpu_torch.ml import engine as port_engine
from eioku_tpu_torch.ml.combined import run_visual_analysis
from eioku_tpu_torch.ml.engine import InferenceEngine, ModelNotAvailable
from eioku_tpu_torch.ml.scenes import detect_scenes

REPO = pathlib.Path(__file__).resolve().parent.parent


def _write_video(path, segments, fps=10, size=(64, 64), shapes=False):
    """An mp4v clip of solid-colour segments [(n_frames, (r, g, b)), ...]
    with a little noise; shapes=True adds high-contrast blocks so a detector
    has edges to respond to."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert w.isOpened()
    rng = np.random.default_rng(0)
    f = 0
    for n_frames, (r, g, b) in segments:
        base = np.zeros((size[1], size[0], 3), np.int16)
        base[:, :] = (b, g, r)  # BGR for cv2
        for _ in range(n_frames):
            frame = base + rng.integers(-4, 5, base.shape)
            if shapes:
                x = 40 + 13 * f
                frame[80:260, x:x + 160] = 255 - frame[80:260, x:x + 160]
                frame[200:330, 420:600] = (20, 20, 20)
            w.write(np.clip(frame, 0, 255).astype(np.uint8))
            f += 1
    w.release()


@pytest.fixture(scope="module")
def scene_video(tmp_path_factory):
    # the 3-scene fixture of tests/test_ml_pipeline.py: dark red 2 s,
    # bright green 3 s, blue 2 s at 10 fps
    path = str(tmp_path_factory.mktemp("torch_slice") / "scenes.mp4")
    _write_video(path, [(20, (120, 0, 0)), (30, (30, 220, 30)), (20, (10, 10, 230))])
    return path


@pytest.fixture(scope="module")
def detector_clip(tmp_path_factory):
    # 640x360: the combined pass decodes at detector scale and the detector
    # pads 360 -> 384 on the device (the I420 detector-scale route)
    path = str(tmp_path_factory.mktemp("torch_slice") / "objects.mp4")
    _write_video(path, [(15, (180, 60, 40)), (15, (40, 90, 200))], fps=10,
                 size=(640, 360), shapes=True)
    return path


@pytest.fixture(scope="module")
def yolo_cache_dir(tmp_path_factory):
    """A model cache holding yolov8n.pt in the ultralytics layout, from the
    JAX package's seeded random init, so that both packages load the same
    weights (their own random inits differ: jax.random vs torch.Generator)."""
    d = tmp_path_factory.mktemp("torch_slice_models")
    cfg = JaxYoloConfig("yolov8n")
    sd = export_ultralytics_state_dict(init_yolo_params(cfg, seed=0), cfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(d / "yolov8n.pt"))
    return str(d)


def _scene_tuples(scenes):
    return [(s.scene_index, s.start_ms, s.end_ms, s.score) for s in scenes]


def test_detect_scenes_identical_to_jax(scene_video):
    want = jax_detect_scenes(scene_video, decode_fast=0)
    got = detect_scenes(scene_video, decode_fast=0, device="cpu")
    assert len(got) == 3
    assert [(i, a, b) for i, a, b, _ in _scene_tuples(got)] == \
        [(i, a, b) for i, a, b, _ in _scene_tuples(want)]
    # boundary scores are means of float32 sums: identical to 1e-6
    np.testing.assert_allclose([s.score for s in got], [s.score for s in want],
                               rtol=0, atol=1e-6)


def test_visual_analysis_scene_rows_identical_to_jax(scene_video):
    config = {"scene_detection": {}, "decode_fast": 0}
    want = jax_visual_analysis(scene_video, config)
    got = run_visual_analysis(scene_video, config, device="cpu")
    assert set(got) == {"scene_detection"}
    assert got["scene_detection"] == want["scene_detection"]
    assert len(got["scene_detection"]) == 3


def test_visual_analysis_keyframe_cache_matches_jax(scene_video, tmp_path):
    # the pass writes 1 s-grid JPEGs named by timestamp; a stale file in the
    # directory is replaced, not kept
    names = {}
    for side, run in (("jax", jax_visual_analysis),
                      ("torch", partial(run_visual_analysis, device="cpu"))):
        kf = tmp_path / side
        kf.mkdir()
        (kf / "stale.jpg").write_bytes(b"")
        run(scene_video, {"scene_detection": {"sample_fps": 2.0},
                          "decode_fast": 0, "keyframe_cache_dir": str(kf)})
        names[side] = sorted(p.name for p in kf.iterdir())
    assert names["torch"] == names["jax"]
    assert names["torch"] == [f"{t}.jpg" for t in range(0, 7000, 1000)]


def _match_rows(want, got, box_px=2.0, conf_tol=0.02):
    """Greedy one-to-one matching by (frame, label), box corners within
    box_px and confidence within conf_tol; returns the matched count."""
    pool: dict = {}
    for r in got:
        p = r["payload"]
        pool.setdefault((p["frame_number"], p["label"]), []).append(p)
    matched = 0
    for r in want:
        p = r["payload"]
        cands = pool.get((p["frame_number"], p["label"]), [])
        for i, q in enumerate(cands):
            bp, bq = p["bounding_box"], q["bounding_box"]
            if abs(p["confidence"] - q["confidence"]) <= conf_tol and all(
                    abs(bp[k] - bq[k]) <= box_px for k in ("x", "y")) and all(
                    abs((bp[a] + bp[b]) - (bq[a] + bq[b])) <= box_px
                    for a, b in (("x", "width"), ("y", "height"))):
                matched += 1
                del cands[i]
                break
    return matched


@partial(jax.jit, static_argnames=("cfg", "conf_threshold"))
def _jax_detect_i420_fp32(params, planes, cfg, conf_threshold):
    """The JAX pass's `_detect_i420` without its bf16 cast."""
    return jax_detect(params, jax_i420_to_rgb(planes), cfg,
                      conf_threshold=conf_threshold)


def test_visual_analysis_object_rows_match_jax(detector_clip, yolo_cache_dir,
                                               monkeypatch):
    # The JAX pass runs its detector in bf16 (ml/combined.py _detect_i420),
    # the port runs fp32 on the CPU. With random weights every candidate
    # scores within ~0.002 of the others, so bf16 rounding reorders them and
    # a different one of many near-identical overlapping boxes survives NMS:
    # on this clip only 28 of 54 rows matched. The comparison therefore holds
    # the JAX detector at fp32 (the same function without the cast); at
    # least 98% of rows must match (the tolerance the JAX package accepted
    # between two of its own programs), and the remaining differences would
    # come from fp32 summation order.
    monkeypatch.setattr(jax_combined, "_detect_i420", _jax_detect_i420_fp32)
    config = {"scene_detection": {}, "decode_fast": 0,
              "object_detection": {"batch_size": 4}}
    want = jax_visual_analysis(detector_clip, config, yolo_cache_dir)
    got = run_visual_analysis(detector_clip, config, yolo_cache_dir, device="cpu")
    assert got["scene_detection"] == want["scene_detection"]
    jrows, trows = want["object_detection"], got["object_detection"]
    assert len(jrows) > 0
    assert {r["payload"]["frame_number"] for r in trows} <= {0, 10, 20}
    matched = _match_rows(jrows, trows)
    assert matched >= 0.98 * max(len(jrows), len(trows)), \
        (matched, len(jrows), len(trows))


def test_visual_analysis_ignores_top_k_like_jax(detector_clip, yolo_cache_dir,
                                                monkeypatch):
    # the JAX combined pass never reads object_detection.top_k (its
    # _detect_i420 calls detect with the default pool of 256); the port's
    # pass must give the same rows with top_k set, at one precision (fp32,
    # see test_visual_analysis_object_rows_match_jax)
    monkeypatch.setattr(jax_combined, "_detect_i420", _jax_detect_i420_fp32)
    config = {"decode_fast": 0,
              "object_detection": {"batch_size": 4, "top_k": 8}}
    want = jax_visual_analysis(detector_clip, config, yolo_cache_dir)
    got = run_visual_analysis(detector_clip, config, yolo_cache_dir, device="cpu")
    plain = run_visual_analysis(
        detector_clip, {"decode_fast": 0, "object_detection": {"batch_size": 4}},
        yolo_cache_dir, device="cpu")
    jrows, trows = want["object_detection"], got["object_detection"]
    assert trows == plain["object_detection"]  # top_k changes nothing
    per_frame = [sum(r["payload"]["frame_number"] == f for r in trows)
                 for f in {r["payload"]["frame_number"] for r in trows}]
    assert max(per_frame) > 8  # more rows than the ignored cap would allow
    matched = _match_rows(jrows, trows)
    assert matched >= 0.98 * max(len(jrows), len(trows)), \
        (matched, len(jrows), len(trows))


def test_object_detection_task_honours_top_k(detector_clip):
    rows = InferenceEngine(device="cpu").run_task(
        "object_detection", detector_clip,
        {"batch_size": 4, "confidence_threshold": 0.0, "top_k": 8,
         "decode_fast": 0})
    frames = {r["payload"]["frame_number"] for r in rows}
    per_frame = [sum(r["payload"]["frame_number"] == f for r in rows)
                 for f in frames]
    assert frames and max(per_frame) <= 8


# options of a task the port runs, still refused
_STILL_REFUSED = {"transcription": {"compute_dtype": "int8"}}


@pytest.mark.parametrize("task_type", [
    "metadata_extraction", "face_detection", "transcription", "ocr",
    "place_classification", "semantic_indexing", "speaker_diarization",
    "no_such_task"])
def test_unported_tasks_raise(task_type, scene_video):
    with pytest.raises(ModelNotAvailable):
        InferenceEngine(device="cpu").run_task(
            task_type, scene_video, _STILL_REFUSED.get(task_type, {}))


@pytest.mark.parametrize("config,needle", [
    ({"scene_detection": {}, "face_detection": {}}, "face_detection"),
    ({"object_detection": {}, "place_classification": {}}, "place_classification"),
    ({"scene_detection": {}, "ocr": {}}, "ocr"),
    ({"object_detection": {"int8": True}}, "int8"),
    ({"object_detection": {"preprocess": "device"}}, "preprocess"),
    ({"object_detection": {"data_parallel": True}}, "data-parallel"),
])
def test_unported_visual_configs_raise(config, needle, scene_video):
    with pytest.raises(ModelNotAvailable, match=needle):
        InferenceEngine(device="cpu").run_task("visual_analysis", scene_video,
                                               config)


def test_object_detection_task_refuses_int8(scene_video):
    with pytest.raises(ModelNotAvailable):
        InferenceEngine(device="cpu").run_task("object_detection", scene_video,
                                               {"int8": True})


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine()
    engine = InferenceEngine(device="cpu")
    assert engine.producer_name == "eioku-tpu-torch-engine"
    info = port_engine.device_info()
    assert info == {"backend": "unavailable", "device_count": 0, "devices": [],
                    "error": "device backend unreachable"}


def test_engine_scene_task_matches_visual_pass_shape(scene_video):
    rows = InferenceEngine(device="cpu").run_task(
        "scene_detection", scene_video, {"decode_fast": 0})
    assert [r["payload"]["scene_index"] for r in rows] == [0, 1, 2]
    assert all(set(r) == {"payload", "span_start_ms", "span_end_ms"} for r in rows)


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "eioku_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imported_modules(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "eioku_tpu"), (f, name)
