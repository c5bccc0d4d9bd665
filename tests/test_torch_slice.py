"""The PyTorch port's combined visual pass end to end against the JAX
package (CPU).

The combined visual pass (scenes, YOLOv8n objects, yolov8n-face faces with
ArcFace embeddings, ResNet18-Places365 places) on each of its routes, and
standalone scene and object detection, run through both packages on the
same synthetic clips; the engine runs OCR standalone and folded into the
pass, and refuses what it does not cover; the pass takes the detection
options as the JAX pass does; the port imports nothing of JAX or of the JAX
package.
"""
import ast
import pathlib
from functools import partial

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.ml import combined as jax_combined
from eioku_tpu.ml.combined import run_visual_analysis as jax_visual_analysis
from eioku_tpu.ml.scenes import detect_scenes as jax_detect_scenes
from eioku_tpu.models.face_embed.model import init_face_embed_params
from eioku_tpu.models.resnet.model import IMAGENET_MEAN as JAX_IMAGENET_MEAN
from eioku_tpu.models.resnet.model import IMAGENET_STD as JAX_IMAGENET_STD
from eioku_tpu.models.resnet.model import init_resnet18_params, resnet18_forward
from eioku_tpu.models.yolo.model import YoloConfig as JaxYoloConfig
from eioku_tpu.models.yolo.model import init_yolo_params
from eioku_tpu.models.yolo.postprocess import detect as jax_detect
from eioku_tpu.models.yolo.weights import export_ultralytics_state_dict
from eioku_tpu.ops.colorspace import i420_to_rgb as jax_i420_to_rgb
from eioku_tpu_torch.ml import combined as port_combined
from eioku_tpu_torch.ml import engine as port_engine
from eioku_tpu_torch.ml.combined import run_visual_analysis
from eioku_tpu_torch.ml.engine import InferenceEngine, ModelNotAvailable
from eioku_tpu_torch.ml.scenes import detect_scenes
from eioku_tpu_torch.models.face_embed.model import from_jax_params as arcface_from_jax
from eioku_tpu_torch.models.resnet.model import from_jax_params as resnet_from_jax
from test_torch_ocr import single_torch_thread
from test_torch_places import assert_place_rows_match

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


def _match_pairs(want, got, box_px=2.0, conf_tol=0.02):
    """Greedy one-to-one matching by (frame, label) -- faces have no label
    -- with box corners within box_px and confidence within conf_tol;
    returns the matched (want, got) payload pairs."""
    pool: dict = {}
    for r in got:
        p = r["payload"]
        pool.setdefault((p["frame_number"], p.get("label")), []).append(p)
    pairs = []
    for r in want:
        p = r["payload"]
        cands = pool.get((p["frame_number"], p.get("label")), [])
        for i, q in enumerate(cands):
            bp, bq = p["bounding_box"], q["bounding_box"]
            if abs(p["confidence"] - q["confidence"]) <= conf_tol and all(
                    abs(bp[k] - bq[k]) <= box_px for k in ("x", "y")) and all(
                    abs((bp[a] + bp[b]) - (bq[a] + bq[b])) <= box_px
                    for a, b in (("x", "width"), ("y", "height"))):
                pairs.append((p, q))
                del cands[i]
                break
    return pairs


def _match_rows(want, got, box_px=2.0, conf_tol=0.02):
    """The number of rows `_match_pairs` matches."""
    return len(_match_pairs(want, got, box_px, conf_tol))


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


# -- the whole combined pass: scenes, objects, faces (with embeddings), places

FACE_CONF = 0.2  # random yolov8n-face weights score every anchor near 0.5
COSINE_MIN = 0.9999  # normalised face embeddings, JAX against the port
ROW_MATCH = 0.98  # share of object and face rows that must match


@pytest.fixture(scope="module")
def visual_cache_dir(tmp_path_factory):
    """yolov8n.pt, yolov8n-face.pt, resnet18_places365.pth and
    arcface_r18.pth from the JAX package's seeded trees (the two ResNets
    written in torch layout through the port's from_jax_params, whose key
    mapping tests/test_torch_{places,faces}.py hold on their own)."""
    d = tmp_path_factory.mktemp("torch_visual_models")
    for name, classes in (("yolov8n", 80), ("yolov8n-face", 1)):
        cfg = JaxYoloConfig("yolov8n", num_classes=classes)
        sd = export_ultralytics_state_dict(init_yolo_params(cfg, seed=0), cfg)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   str(d / f"{name}.pt"))
    torch.save(resnet_from_jax(init_resnet18_params(365, seed=0)).state_dict(),
               str(d / "resnet18_places365.pth"))
    torch.save(arcface_from_jax(init_face_embed_params(seed=0)).state_dict(),
               str(d / "arcface_r18.pth"))
    return str(d)


def _jax_normalize(rgb):
    return (rgb - jnp.asarray(JAX_IMAGENET_MEAN)) / jnp.asarray(JAX_IMAGENET_STD)


def _jax_places_from_rgb(pparams, rgb, top_k):
    b = rgb.shape[0]
    imgs = jax.image.resize(rgb, (b, 224, 224, 3), method="bilinear")
    probs = jax.nn.softmax(resnet18_forward(pparams, _jax_normalize(imgs)), axis=-1)
    return jax.lax.top_k(probs, top_k)


def _jax_detect_fp32(params, images, cfg, **kw):
    """The JAX detect without the bf16 cast of its uint8 path."""
    images = jnp.asarray(images)
    if images.dtype == jnp.uint8:
        images = images.astype(jnp.float32) / 255.0
    return jax_detect(params, images, cfg, **kw)


@partial(jax.jit, static_argnames=("top_k",))
def _jax_places_i420_fp32(pparams, planes, top_k):
    probs = jax.nn.softmax(resnet18_forward(
        pparams, _jax_normalize(jax_i420_to_rgb(planes))), axis=-1)
    return jax.lax.top_k(probs, top_k)


@partial(jax.jit, static_argnames=("ycfg", "fcfg"))
def _jax_detect_faces_i420_fp32(yparams, fparams, planes, face_idx, ycfg, fcfg,
                                conf_threshold, face_conf):
    rgb = jax_i420_to_rgb(planes)
    return (jax_detect(yparams, rgb, ycfg, conf_threshold=conf_threshold),
            jax_detect(fparams, rgb[face_idx], fcfg, conf_threshold=face_conf))


@partial(jax.jit, static_argnames=("ycfg", "fcfg", "top_k"))
def _jax_detect_places_faces_i420_fp32(yparams, pparams, fparams, planes, face_idx,
                                       ycfg, fcfg, conf_threshold, top_k, face_conf):
    rgb = jax_i420_to_rgb(planes)
    det = jax_detect(yparams, rgb, ycfg, conf_threshold=conf_threshold)
    sc, idx = _jax_places_from_rgb(pparams, rgb, top_k)
    return det, sc, idx, jax_detect(fparams, rgb[face_idx], fcfg,
                                    conf_threshold=face_conf)


@partial(jax.jit, static_argnames=("ycfg", "conf_threshold", "top_k"))
def _jax_detect_places_i420_fp32(yparams, pparams, planes, ycfg, conf_threshold,
                                 top_k):
    rgb = jax_i420_to_rgb(planes)
    det = jax_detect(yparams, rgb, ycfg, conf_threshold=conf_threshold)
    sc, idx = _jax_places_from_rgb(pparams, rgb, top_k)
    return det, sc, idx


def _jax_pass_at_fp32(monkeypatch):
    """Every device program of the JAX pass without its bf16 casts (hazard
    b: with random weights, rows compare at one precision only)."""
    for name, twin in (("detect", _jax_detect_fp32),
                       ("_detect_i420", _jax_detect_i420_fp32),
                       ("_places_i420", _jax_places_i420_fp32),
                       ("_detect_faces_i420", _jax_detect_faces_i420_fp32),
                       ("_detect_places_faces_i420", _jax_detect_places_faces_i420_fp32),
                       ("_detect_places_i420", _jax_detect_places_i420_fp32)):
        monkeypatch.setattr(jax_combined, name, twin)


def assert_face_rows_match(want, got):
    """>= ROW_MATCH of the face rows matched (by frame, box and confidence);
    on matched rows the same keys and cluster ids and, with embeddings, a
    unit-norm embedding within COSINE_MIN of the JAX package's."""
    assert len(want) > 0
    pairs = _match_pairs(want, got)
    assert len(pairs) >= ROW_MATCH * max(len(want), len(got)), \
        (len(pairs), len(want), len(got))
    for jp, tp in pairs:
        assert set(tp) == set(jp)
        assert tp["cluster_id"] == jp["cluster_id"]
        if "embedding" in jp:
            a, b = np.asarray(jp["embedding"]), np.asarray(tp["embedding"])
            assert abs(np.linalg.norm(b) - 1.0) < 1e-4
            assert float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) >= COSINE_MIN


def _assert_visual_rows_match(want, got):
    assert set(got) == set(want)
    assert got["scene_detection"] == want["scene_detection"]
    jrows, trows = want["object_detection"], got["object_detection"]
    assert len(jrows) > 0
    assert _match_rows(jrows, trows) >= ROW_MATCH * max(len(jrows), len(trows))
    assert_face_rows_match(want["face_detection"], got["face_detection"])
    assert all("embedding" in r["payload"] for r in got["face_detection"])
    assert_place_rows_match(got["place_classification"], want["place_classification"])


def _full_config(faces: dict | None = None, places: dict | None = None, **top):
    return {"scene_detection": {}, "decode_fast": 0,
            "object_detection": {"batch_size": 4},
            "face_detection": {"batch_size": 4, "confidence_threshold": FACE_CONF,
                               "embeddings": True, **(faces or {})},
            "place_classification": {"batch_size": 4, **(places or {})}, **top}


# (clip, config, the JAX device programs the route must reach). On the
# 640x360 clip at 10 fps the scene cadence makes the base step 2 frames:
# objects and places every 10, faces every 16 (1.6 s), 20 (2 s) or 30.
_ROUTES = {
    # places fuse into the object upload; 16 % 10 != 0: own face consumer
    "fused_places": ("detector_clip", _full_config(faces={"frame_interval_s": 1.6}),
                     {"_detect_places_i420", "_detect_i420"}),
    # faces every 20 frames ride the object upload as a device-side gather
    "fully_fused": ("detector_clip", _full_config(faces={"frame_interval_s": 2.0}),
                    {"_detect_places_faces_i420"}),
    # no rider, places every 20 frames: their own host-resized batches
    "separate": ("detector_clip", _full_config(faces={"frame_interval_s": 2.0},
                                               places={"frame_interval_s": 2.0},
                                               fuse_faces=False),
                 {"_detect_i420", "_places_i420"}),
    # 64x64 frames are letterboxed: places resize the raw frames on the host
    # and the rider's frames are gathered on the host
    "letterbox": ("scene_video", _full_config(),
                  {"_detect_i420", "_places_i420", "detect"}),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_visual_analysis_full_pass_matches_jax(route, request, visual_cache_dir,
                                               monkeypatch):
    clip_fixture, config, programs = _ROUTES[route]
    clip = request.getfixturevalue(clip_fixture)
    _jax_pass_at_fp32(monkeypatch)
    jax_calls = _record_calls(monkeypatch, jax_combined, programs)
    port_calls = _record_calls(monkeypatch, port_combined, programs)
    want = jax_visual_analysis(clip, config, visual_cache_dir)
    got = InferenceEngine(model_cache_dir=visual_cache_dir, device="cpu").run_task(
        "visual_analysis", clip, config)
    assert jax_calls == port_calls == programs  # both took the route named
    _assert_visual_rows_match(want, got)


def _record_calls(monkeypatch, module, names) -> set:
    """Wrap module.<name> for each name; the returned set collects the names
    called."""
    calls = set()
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, (
            lambda name, fn: lambda *a, **kw: (calls.add(name), fn(*a, **kw))[1])(name, fn))
    return calls


def test_fused_faces_match_separate_consumer(tmp_path, visual_cache_dir):
    # the face rider (a device-side gather from the object upload) gives the
    # same face stream as the separate face consumer: a >= 640-wide source
    # decodes to detector scale and engages the fused I420 route
    path = str(tmp_path / "wide.mp4")
    _write_video(path, [(30, (200, 40, 40)), (30, (40, 200, 40))], fps=12,
                 size=(960, 540), shapes=True)
    cfg = {"decode_fast": 0,
           "object_detection": {"batch_size": 8, "frame_interval_s": 1.0},
           "face_detection": {"batch_size": 8, "frame_interval_s": 3.0,
                              "confidence_threshold": FACE_CONF}}
    engine = InferenceEngine(model_cache_dir=visual_cache_dir, device="cpu")
    fused = engine.run_task("visual_analysis", path, cfg)["face_detection"]
    separate = engine.run_task("visual_analysis", path,
                               {**cfg, "fuse_faces": False})["face_detection"]
    assert len(fused) == len(separate) > 0
    assert {r["payload"]["frame_number"] for r in fused} == {0, 36}
    for f, s in zip(fused, separate):
        assert f["span_start_ms"] == s["span_start_ms"]
        assert f["payload"]["cluster_id"] == s["payload"]["cluster_id"]
        fb, sb = f["payload"]["bounding_box"], s["payload"]["bounding_box"]
        for k in ("x", "y", "width", "height"):
            assert abs(fb[k] - sb[k]) < 2.0, (fb, sb)


@pytest.mark.parametrize("task_type", ["transcription", "semantic_indexing",
                                       "no_such_task"])
def test_unported_tasks_raise(task_type, scene_video, tmp_path, monkeypatch, caplog):
    """Tasks the engine does not run raise ModelNotAvailable. transcription
    was the last task with a refused option (tensor_parallel where the JAX
    package shards); it now shards instead, over two CPU entries standing
    in for two cards, and its random weights emit no row."""
    import wave

    from eioku_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "local_devices", lambda device=None: [torch.device("cpu")] * 2)
    media = scene_video
    if task_type == "transcription":  # a voiced second of audio
        media = str(tmp_path / "tone.wav")
        t = np.arange(16000) / 16000
        with wave.open(media, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16).tobytes())
        with caplog.at_level("INFO", logger="eioku_tpu_torch.ml.transcribe"):
            rows = InferenceEngine(device="cpu").run_task(
                task_type, media, {"model": "tiny", "tensor_parallel": 2,
                                   "compute_dtype": "float32"})
        assert rows == [] and "tensor-parallel transcription" in caplog.text
        return
    with pytest.raises(ModelNotAvailable):
        InferenceEngine(device="cpu").run_task(task_type, media, {})


def _check_ocr_rows(rows: list[dict]) -> None:
    """Valid ocr.text payloads of the clip's first frame (the 7 s grid of
    the 7 s clip: one 384x640 CRAFT frame, cheap on the CPU)."""
    from eioku_tpu_torch.domain.schema_registry import SchemaRegistry, register_all_schemas

    register_all_schemas()
    for r in rows:
        SchemaRegistry.validate("ocr.text", 1, r["payload"])
        assert r["payload"]["languages"] == ["en"]
        assert r["payload"]["frame_index"] == 0
        assert r["span_end_ms"] - r["span_start_ms"] == 100


# OCR runs standalone and folded into visual_analysis: the configs the
# engine refused before OCR was ported (tests/test_torch_ocr.py holds the
# rows against the JAX package)
_OCR_ONE_FRAME = {"batch_size": 1, "frame_interval_s": 7.0}


@pytest.mark.parametrize("task_type,config", [
    ("ocr", _OCR_ONE_FRAME),
    ("visual_analysis", {"object_detection": {}, "place_classification": {},
                         "ocr": _OCR_ONE_FRAME}),
    ("visual_analysis", {"scene_detection": {}, "ocr": _OCR_ONE_FRAME}),
])
def test_ocr_task_and_folds_run(task_type, config, scene_video):
    with single_torch_thread():  # the CPU LSTM under the suite's load
        out = InferenceEngine(device="cpu").run_task(task_type, scene_video,
                                                     {**config, "decode_fast": 0})
    if task_type == "ocr":
        _check_ocr_rows(out)
        return
    assert set(out) == set(config)
    _check_ocr_rows(out["ocr"])
    for sub in set(config) - {"ocr"}:
        assert out[sub], sub


# the detection options the pass refused before: like the JAX pass it
# ignores preprocess and data_parallel, and quantizes objects and faces
_PASS_OPTIONS = {
    "preprocess": {"scene_detection": {}, "decode_fast": 0,
                   "object_detection": {"batch_size": 4, "preprocess": "device"}},
    "data_parallel": {"decode_fast": 0,
                      "object_detection": {"batch_size": 4, "data_parallel": True}},
    "int8_objects": {"decode_fast": 0, "object_detection": {"batch_size": 4, "int8": True}},
    "int8_faces": {"scene_detection": {}, "decode_fast": 0,
                   "face_detection": {"batch_size": 4, "int8": True,
                                      "confidence_threshold": FACE_CONF}},
}


@pytest.mark.parametrize("option", sorted(_PASS_OPTIONS))
def test_visual_pass_detection_options_match_jax(option, detector_clip, visual_cache_dir,
                                                 monkeypatch):
    """Rows against the JAX pass's at fp32 (hazard b; decode_fast 0, hazard
    a; no artifact ids or producer in the pass's rows, hazard i). int8 runs
    teacher-forced on the JAX run's quantizations (tests/
    test_torch_quant_conv.py, hazard r)."""
    from test_torch_quant_conv import (
        assert_int8_rows_match,
        port_takes_recorded,
        record_jax_quantizations,
    )

    config = _PASS_OPTIONS[option]
    _jax_pass_at_fp32(monkeypatch)
    engine = InferenceEngine(model_cache_dir=visual_cache_dir, device="cpu")
    sub = "face_detection" if option == "int8_faces" else "object_detection"
    if option.startswith("int8"):
        with record_jax_quantizations() as rec:
            want = jax_visual_analysis(detector_clip, config, visual_cache_dir)
        stats = {}
        with port_takes_recorded(rec, stats):
            got = engine.run_task("visual_analysis", detector_clip, config)
        assert rec.at == len(rec.calls) > 0
        assert_int8_rows_match(want[sub], got[sub], stats)
    else:
        want = jax_visual_analysis(detector_clip, config, visual_cache_dir)
        got = engine.run_task("visual_analysis", detector_clip, config)
        # ignored, as in the JAX pass: the rows of the pass without the key
        plain = {**config, sub: {k: v for k, v in config[sub].items()
                                 if k not in ("preprocess", "data_parallel")}}
        assert got == engine.run_task("visual_analysis", detector_clip, plain)
        jrows, trows = want[sub], got[sub]
        assert len(jrows) > 0
        assert _match_rows(jrows, trows) >= ROW_MATCH * max(len(jrows), len(trows))
    assert set(got) == set(want)
    if "scene_detection" in config:
        assert got["scene_detection"] == want["scene_detection"]


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
    assert len(files) >= 94
    for f in files:
        for name in _imported_modules(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "eioku_tpu"), (f, name)
