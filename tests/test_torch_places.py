"""The PyTorch port's places classification (eioku_tpu_torch.models.resnet,
eioku_tpu_torch.ml.places) against the JAX package, on the CPU at fp32.

Weights come from the JAX package's seeded `init_resnet18_params`, carried
over directly (`from_jax_params`) and, for the task, written once as a
torchvision-layout `resnet18_places365.pth` that both packages load.
"""
import shutil
from functools import lru_cache

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eioku_tpu.ml import places as jax_places
from eioku_tpu.models.resnet.model import (
    IMAGENET_MEAN as JAX_MEAN,
    IMAGENET_STD as JAX_STD,
    init_resnet18_params,
    load_places365 as jax_load_places365,
    resnet18_forward,
)
from eioku_tpu_torch.ml.combined import resize_for_places
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.ml.places import classify, run_place_classification
from eioku_tpu_torch.models.resnet.model import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ResNet18,
    from_jax_params,
    load_places365,
    load_torchvision_state_dict,
    preprocess,
)

# fp32 logits through 18 layers summed in another order: measured ~1e-4 at
# |logit| ~130 (7.6e-7 relative)
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-3
CONF_TOL = 1e-5  # place confidences (softmax probabilities)
RESIZE_TOL = 1e-5  # antialiased bilinear resize, both fp32


@lru_cache(maxsize=None)
def _jax_tree():
    return init_resnet18_params(365, seed=0)


def torchvision_state_dict(tree) -> dict:
    """The JAX tree in torchvision's resnet18 layout, written out key by key
    (independent of the port's converter)."""
    def cw(w):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))

    def bn(prefix, p, sd):
        for ours, theirs in (("gamma", "weight"), ("beta", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.{theirs}"] = torch.from_numpy(np.array(p[ours], np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    sd = {"conv1.weight": cw(tree["conv1"]["w"]),
          "fc.weight": torch.from_numpy(np.array(tree["fc"]["w"], np.float32).T.copy()),
          "fc.bias": torch.from_numpy(np.array(tree["fc"]["b"], np.float32))}
    bn("bn1", tree["bn1"], sd)
    for si, blocks in enumerate(tree["layers"]):
        for bi, blk in enumerate(blocks):
            base = f"layer{si + 1}.{bi}"
            sd[f"{base}.conv1.weight"] = cw(blk["conv1"]["w"])
            sd[f"{base}.conv2.weight"] = cw(blk["conv2"]["w"])
            bn(f"{base}.bn1", blk["bn1"], sd)
            bn(f"{base}.bn2", blk["bn2"], sd)
            if "down" in blk:
                sd[f"{base}.downsample.0.weight"] = cw(blk["down"]["w"])
                bn(f"{base}.downsample.1", blk["down"]["bn"], sd)
    return sd


def _write_clip(path, n_frames=25, fps=10, size=(320, 180)):
    """Colour segments with a moving block, so that frames differ."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert w.isOpened()
    rng = np.random.default_rng(0)
    for f in range(n_frames):
        frame = np.zeros((size[1], size[0], 3), np.int16)
        frame[:] = (40, 90, 200) if f < n_frames // 2 else (200, 150, 30)
        frame += rng.integers(-4, 5, frame.shape)
        x = 10 + 9 * f
        frame[40:140, x:x + 80] = 255 - frame[40:140, x:x + 80]
        w.write(np.clip(frame, 0, 255).astype(np.uint8))
    w.release()


@pytest.fixture(scope="module")
def places_cache(tmp_path_factory):
    """resnet18_places365.pth.tar ({"state_dict": ...}, 'module.'-prefixed
    keys, as the places365 release ships it) and categories_places365.txt."""
    d = tmp_path_factory.mktemp("torch_places_models")
    sd = {f"module.{k}": v for k, v in torchvision_state_dict(_jax_tree()).items()}
    torch.save({"epoch": 90, "state_dict": sd}, str(d / "resnet18_places365.pth.tar"))
    (d / "categories_places365.txt").write_text(
        "".join(f"/{chr(97 + i % 26)}/class_{i}/{'indoor' if i % 2 else 'outdoor'} {i}\n"
                for i in range(365)))
    return str(d)


@pytest.fixture(scope="module")
def places_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_places") / "places.mp4")
    _write_clip(path)
    return path


def test_imagenet_constants_match_jax():
    np.testing.assert_array_equal(IMAGENET_MEAN, JAX_MEAN)
    np.testing.assert_array_equal(IMAGENET_STD, JAX_STD)


def test_logits_match_jax():
    tree = _jax_tree()
    model = from_jax_params(tree).eval()
    x = np.random.default_rng(0).normal(0, 1, (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(resnet18_forward(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 365)
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * max(1.0, float(np.abs(want).max()) / 100))


def test_from_jax_params_equals_state_dict_load():
    a = from_jax_params(_jax_tree()).state_dict()
    b = load_torchvision_state_dict(torchvision_state_dict(_jax_tree())).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_loader_rejects_a_mismatched_state_dict():
    sd = torchvision_state_dict(_jax_tree())
    del sd["layer2.0.downsample.0.weight"]
    with pytest.raises(KeyError, match="downsample"):
        load_torchvision_state_dict(sd)


@pytest.mark.parametrize("name", ["resnet18_places365.pth.tar", "resnet18_places365.pth"])
def test_load_places365_reads_checkpoint_and_labels(name, places_cache, tmp_path):
    # both checkpoint names; the labels keep the indoor/outdoor qualifier
    shutil.copy(f"{places_cache}/categories_places365.txt", tmp_path)
    sd = torchvision_state_dict(_jax_tree())
    torch.save(sd if name.endswith(".pth") else {"state_dict": sd}, str(tmp_path / name))
    model, labels, pretrained = load_places365(str(tmp_path))
    _, jax_labels, jax_pretrained = jax_load_places365(str(tmp_path))
    assert pretrained and jax_pretrained
    assert labels == jax_labels and labels[1] == "class_1/indoor"
    want = from_jax_params(_jax_tree()).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_random_init_is_seeded():
    a, labels, pretrained = load_places365(None, seed=3)
    b, _, _ = load_places365(None, seed=3)
    assert not pretrained and labels == [f"place_{i}" for i in range(365)]
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert isinstance(a, ResNet18)


def test_preprocess_matches_jax():
    frames = np.random.default_rng(4).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    want = (frames.astype(np.float32) / 255.0 - JAX_MEAN) / JAX_STD
    got = preprocess(torch.from_numpy(frames)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_top_k_breaks_ties_by_lower_index_like_jax():
    # a zero fc gives 365 equal probabilities: the stable sort must return
    # classes 0..k-1, as jax.lax.top_k does
    model = ResNet18(generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        model.fc.weight.zero_()
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    scores, idx = classify(model, x, 5)
    _, jidx = jax.lax.top_k(jnp.full((2, 365), 1 / 365, jnp.float32), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(scores.numpy(), 1 / 365, rtol=1e-6)


@pytest.mark.parametrize("hw", [(360, 640), (384, 640), (224, 224)])
def test_antialiased_resize_matches_jax(hw):
    rgb = np.random.default_rng(hw[0]).random((2, *hw, 3), dtype=np.float32)
    want = jax.image.resize(jnp.asarray(rgb), (2, 224, 224, 3), method="bilinear")
    got = resize_for_places(torch.from_numpy(rgb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESIZE_TOL)


def _jax_preprocess_fp32(frames_u8):
    """The JAX places preprocess without its bf16 cast."""
    x = frames_u8.astype(jnp.float32) / 255.0
    return (x - JAX_MEAN) / JAX_STD


def assert_place_rows_match(got, want):
    """Rows for the same frames and spans, labels equal, confidences within
    CONF_TOL."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["span_start_ms"] == w["span_start_ms"]
        assert g["span_end_ms"] == w["span_end_ms"]
        assert g["payload"]["frame_number"] == w["payload"]["frame_number"]
        gp, wp = g["payload"]["predictions"], w["payload"]["predictions"]
        assert [p["label"] for p in gp] == [p["label"] for p in wp]
        np.testing.assert_allclose([p["confidence"] for p in gp],
                                   [p["confidence"] for p in wp], rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("config", [
    {"batch_size": 4, "decode_fast": 0},
    {"batch_size": 8, "top_k": 3, "frame_interval_s": 0.5, "decode_fast": 0},
])
def test_run_place_classification_matches_jax(config, places_clip, places_cache,
                                              monkeypatch):
    # the JAX task casts its input to bf16 (resnet preprocess); compare at
    # fp32, the port's CPU type
    monkeypatch.setattr(jax_places, "preprocess", _jax_preprocess_fp32)
    jax_places._model.cache_clear()
    want = jax_places.run_place_classification(places_clip, config, places_cache)
    got = InferenceEngine(model_cache_dir=places_cache, device="cpu").run_task(
        "place_classification", places_clip, config)
    assert_place_rows_match(got, want)
    assert len(got[0]["payload"]["predictions"]) == config.get("top_k", 5)


def test_run_place_classification_random_weights(places_clip):
    rows = run_place_classification(places_clip, {"batch_size": 4, "decode_fast": 0},
                                    device="cpu")
    assert [r["payload"]["frame_number"] for r in rows] == [0, 10, 20]
    for r in rows:
        confs = [p["confidence"] for p in r["payload"]["predictions"]]
        assert confs == sorted(confs, reverse=True) and len(confs) == 5
        assert all(p["label"].startswith("place_") for p in r["payload"]["predictions"])
