"""The PyTorch port's OCR (CRAFT + CRNN) against the JAX package (CPU, fp32).

- The new layers: bilinear 2x upsampling (edges included) and CRNN's VALID
  (2, 1) max pools equal jax.image.resize and lax.reduce_window.
- CRAFT at [1, 96, 160, 3] within 1e-4 of the largest |map| and CRNN
  logits at [2, 32, W, 1] for every bucket width within 1e-5, on the JAX
  package's seeded trees carried over with `from_jax_params`; EasyOCR-layout
  state dicts give the same outputs through both packages' converters.
- The copied host stages give equal results on identical maps and crops;
  the checkpoint fallbacks pick the same recognizer and charset.
- `run_ocr` and the OCR fold of `visual_analysis` give the JAX package's
  rows on a synthetic text clip, both packages' detector input set to
  96x160 (`use_small_detector`; the tasks' 384x640 costs 16x more CPU). Random CRAFT weights put every region
  score below 0 and every affinity score above 1 (one component, no row),
  so both packages load one written checkpoint: the JAX package's seeded
  trees with the CRAFT head's two biases shifted by HEAD_SHIFT, which gives
  a few components a frame. Rows are compared only after asserting that no
  map value lies within the maps' tolerance of a threshold where it decides
  a component (a flip would change it) and that every step's top-1 logit
  leads its runner-up by more than twice the two packages' largest logit
  difference on that crop (a flip would change a character).
"""
import contextlib
import functools

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from eioku_tpu.ml import ocr_task as jax_ocr
from eioku_tpu.ml.combined import run_visual_analysis as jax_visual_analysis
from eioku_tpu.models.layers import max_pool as jax_max_pool
from eioku_tpu.models.layers import upsample2x_bilinear as jax_upsample
from eioku_tpu.models.ocr import weights as jax_weights
from eioku_tpu.models.ocr.craft import craft_forward, init_craft_params
from eioku_tpu.models.ocr.crnn import (
    convert_easyocr_recognizer,
    crnn_forward,
    init_crnn_params,
)
from eioku_tpu.models.ocr.weights import convert_craft_state_dict
from eioku_tpu_torch.ml import ocr_task
from eioku_tpu_torch.ml import video_io
from eioku_tpu_torch.ml.combined import run_visual_analysis
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.layers import max_pool, upsample2x_bilinear
from eioku_tpu_torch.models.ocr import craft as port_craft
from eioku_tpu_torch.models.ocr import crnn as port_crnn
from eioku_tpu_torch.models.ocr import weights as port_weights
from eioku_tpu_torch.ops.colorspace import to_i420

CPU = torch.device("cpu")
MAP_TOL = 1e-4  # CRAFT maps, absolute, in the pipeline's comparison
LOGIT_TOL = 1e-5
HEAD_SHIFT = (4.8, -12.0)  # added to the region and affinity biases
# the pipeline tests' detector input (the tasks' is 384x640): CRAFT costs
# ~16x less on the CPU, and the text clip is rendered at this size
SMALL_H, SMALL_W = 96, 160
OCR_CONFIG = {"frame_interval_s": 2.0, "batch_size": 4, "decode_fast": 0}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def single_torch_thread():
    """One intra-op thread for torch on the CPU. The CPU LSTM opens a
    parallel region per time step; with the suite's workers sharing the
    cores, each region's barrier waits on descheduled threads, which made
    a BiLSTM call take seconds instead of milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with single_torch_thread():
        yield


@functools.lru_cache(maxsize=1)
def seeded_trees():
    """The JAX package's CRAFT and CRNN trees at seed 0, as numpy."""
    return _np_tree(init_craft_params(seed=0)), _np_tree(init_crnn_params(seed=0))


@pytest.fixture(scope="module")
def craft_tree():
    return seeded_trees()[0]


@pytest.fixture(scope="module")
def crnn_tree():
    return seeded_trees()[1]


# ---------------------------------------------------------------------------
# layers

@pytest.mark.parametrize("shape", [(1, 3, 5, 2), (2, 6, 10, 4), (1, 1, 1, 3)])
def test_upsample2x_bilinear_matches_jax_at_the_edges(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)  # NHWC
    want = np.asarray(jax_upsample(jnp.asarray(x)))
    got = upsample2x_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,stride,padding", [
    ((2, 1), (2, 1), "VALID"), ((2, 2), (2, 2), "VALID"), (2, 2, "TORCH"), (3, 1, "TORCH")])
def test_max_pool_matches_jax(k, stride, padding):
    x = np.random.default_rng(1).standard_normal((2, 9, 7, 3)).astype(np.float32)
    if padding == "VALID":
        want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                     (1, *k, 1), (1, *stride, 1), "VALID")
    else:
        want = jax_max_pool(jnp.asarray(x), k, stride=stride)
    got = max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), k, stride, padding)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# models

def test_craft_matches_jax(craft_tree):
    x = np.random.default_rng(2).standard_normal((1, 96, 160, 3)).astype(np.float32)
    want = np.asarray(craft_forward(craft_tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port_craft.from_jax_params(craft_tree)(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (1, 48, 80, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_craft_parameter_names_are_easyocr_s(craft_tree):
    sd = port_craft.from_jax_params(craft_tree).state_dict()
    for key in ("basenet.slice1.0.weight", "basenet.slice1.11.running_var",
                "basenet.slice4.38.weight", "basenet.slice5.1.weight",
                "basenet.slice5.2.bias", "upconv1.conv.0.weight", "upconv4.conv.4.bias",
                "conv_cls.0.weight", "conv_cls.8.bias"):
        assert key in sd, key
    assert tuple(sd["basenet.slice5.1.weight"].shape) == (1024, 512, 3, 3)
    assert tuple(sd["upconv1.conv.0.weight"].shape) == (512, 1536, 1, 1)
    assert tuple(sd["conv_cls.8.weight"].shape) == (2, 16, 1, 1)


@pytest.mark.parametrize("width", ocr_task.CROP_WIDTHS)
def test_crnn_logits_match_jax(width, crnn_tree):
    x = np.random.default_rng(width).uniform(-1, 1, (2, 32, width, 1)).astype(np.float32)
    want = np.asarray(crnn_forward(crnn_tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port_crnn.from_jax_params(crnn_tree)(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, width // 4 - 1, port_crnn.charset_size())
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def _easyocr_recognizer_sd(rng, channels=256, hidden=64, n_cls=None):
    """An EasyOCR None-VGG-BiLSTM-CTC state dict with random numpy weights,
    at a narrower width than the default (the converters read widths from
    the shapes)."""
    n_cls = n_cls or port_crnn.charset_size()
    oc = [channels // 8, channels // 4, channels // 2, channels]

    def w(*s):
        return (rng.standard_normal(s) * 0.1).astype(np.float32)
    sd = {}
    for idx, c_out, c_in, k in (("0", oc[0], 1, 3), ("3", oc[1], oc[0], 3),
                                ("6", oc[2], oc[1], 3), ("8", oc[2], oc[2], 3),
                                ("11", oc[3], oc[2], 3), ("14", oc[3], oc[3], 3),
                                ("18", oc[3], oc[3], 2)):
        sd[f"FeatureExtraction.ConvNet.{idx}.weight"] = w(c_out, c_in, k, k)
        if idx not in ("11", "14"):
            sd[f"FeatureExtraction.ConvNet.{idx}.bias"] = w(c_out)
    for idx in ("12", "15"):
        sd[f"FeatureExtraction.ConvNet.{idx}.weight"] = 1 + w(oc[3])
        sd[f"FeatureExtraction.ConvNet.{idx}.bias"] = w(oc[3])
        sd[f"FeatureExtraction.ConvNet.{idx}.running_mean"] = w(oc[3])
        sd[f"FeatureExtraction.ConvNet.{idx}.running_var"] = 1 + np.abs(w(oc[3]))
    for li, d_in in ((0, channels), (1, hidden)):
        for suffix in ("", "_reverse"):
            base = f"SequenceModeling.{li}.rnn"
            sd[f"{base}.weight_ih_l0{suffix}"] = w(4 * hidden, d_in)
            sd[f"{base}.weight_hh_l0{suffix}"] = w(4 * hidden, hidden)
            sd[f"{base}.bias_ih_l0{suffix}"] = w(4 * hidden)
            sd[f"{base}.bias_hh_l0{suffix}"] = w(4 * hidden)
        sd[f"SequenceModeling.{li}.linear.weight"] = w(hidden, 2 * hidden)
        sd[f"SequenceModeling.{li}.linear.bias"] = w(hidden)
    sd["Prediction.weight"] = w(n_cls, hidden)
    sd["Prediction.bias"] = w(n_cls)
    return {f"module.{k}": v for k, v in sd.items()}


def test_easyocr_recognizer_through_both_converters():
    sd = _easyocr_recognizer_sd(np.random.default_rng(3))
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 96, 1)).astype(np.float32)
    want = np.asarray(crnn_forward(convert_easyocr_recognizer(sd), jnp.asarray(x)))
    model = port_crnn.load_easyocr_recognizer(sd)
    assert model.SequenceModeling[0].rnn.hidden_size == 64
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_easyocr_craft_through_both_converters():
    rng = np.random.default_rng(5)
    model = port_craft.CRAFT(generator=torch.Generator().manual_seed(1))
    sd = {}
    for k, v in model.state_dict().items():
        v = v.numpy().astype(np.float32)
        if k.endswith("running_mean") or k.endswith(".bias"):
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            v = v + rng.uniform(0, 0.5, v.shape).astype(np.float32)
        sd[f"module.{k}"] = v
    x = np.random.default_rng(6).standard_normal((1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(craft_forward(convert_craft_state_dict(sd), jnp.asarray(x)))
    with torch.no_grad():
        got = port_craft.load_craft_state_dict(sd)(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# host stages and weights

def _structured_maps(seed: int):
    """Score maps with text-like bars, slanted bars, links and noise."""
    import cv2

    rng = np.random.default_rng(seed)
    region = rng.uniform(-0.2, 0.35, (48, 80)).astype(np.float32)
    affinity = rng.uniform(-0.2, 0.3, (48, 80)).astype(np.float32)
    region[5:10, 4:30] = 0.9
    region[5:10, 34:50] = 0.8
    affinity[6:9, 29:35] = 0.6
    canvas = np.zeros((48, 80), np.uint8)
    cv2.fillPoly(canvas, [cv2.boxPoints(((55, 30), (30, 7), 20.0)).astype(np.int32)], 1)
    region[canvas > 0] = 0.75
    region[40, 3] = 0.99  # too small
    region[30:36, 5:12] = 0.5  # never confident
    return region, affinity


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_stages_equal_on_identical_maps(seed):
    import cv2

    region, affinity = _structured_maps(seed)
    jq = jax_ocr.extract_quads(region, affinity)
    pq = ocr_task.extract_quads(region, affinity)
    assert len(pq) == len(jq) >= 2
    for (jb, jquad), (pb, pquad) in zip(jq, pq):
        assert jb == pb
        np.testing.assert_array_equal(jquad, pquad)
        np.testing.assert_array_equal(jax_ocr._order_quad(jquad), ocr_task._order_quad(pquad))
    assert ocr_task.extract_boxes(region, affinity) == jax_ocr.extract_boxes(region, affinity)
    gray = cv2.GaussianBlur(np.random.default_rng(seed).integers(
        0, 255, (96, 160), np.uint8), (5, 5), 0)
    jc, jm = jax_ocr.detect_text_crops(gray, region, affinity)
    pc, pm = ocr_task.detect_text_crops(gray, region, affinity)
    assert len(pc) == len(jc) == len(pq)
    for a, b in zip(jc, pc):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jm, pm):
        np.testing.assert_array_equal(a, b)
        assert ocr_task.quad_to_source_polygon(b, 2.0, 1.875) == \
            jax_ocr.quad_to_source_polygon(a, 2.0, 1.875)
        wa, wb = jax_ocr.warp_quad_crop(gray, a), ocr_task.warp_quad_crop(gray, b)
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_array_equal(wa, wb)
    for w in (1, 32, 33, 100, 256, 257, 512, 900):
        assert ocr_task._bucket_width(w) == jax_ocr._bucket_width(w)


def test_crop_batch_is_the_jax_batch_channels_first():
    import cv2

    rng = np.random.default_rng(7)
    crops = [rng.integers(0, 255, (32, w), np.uint8) for w in (20, 64, 700)]
    crops.append(rng.integers(0, 255, (40, 50), np.uint8))
    batch = ocr_task.crop_batch(crops, 512)
    # the JAX package's loop (recognize_crops), channels last
    want = np.full((len(crops), 32, 512, 1), -1.0, np.float32)
    for row, c in enumerate(crops):
        if c.shape[1] > 512:
            c = cv2.resize(c, (512, 32))
        w = c.shape[1]
        resized = c if c.shape[0] == 32 else cv2.resize(c, (w, 32))
        want[row, :, :w, 0] = resized.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(batch, want.transpose(0, 3, 1, 2))


def test_ctc_decode_and_charset_are_the_jax_package_s():
    from eioku_tpu.models.ocr.crnn import LATIN_CHARSET, charset_size, ctc_greedy_decode

    assert port_crnn.LATIN_CHARSET == LATIN_CHARSET
    assert port_crnn.charset_size() == charset_size()
    logits = np.random.default_rng(8).standard_normal((3, 20, charset_size())).astype(
        np.float32) * 3
    logits[1, :, 0] = 50.0  # all blank
    assert port_crnn.ctc_greedy_decode(logits) == ctc_greedy_decode(logits)
    assert port_crnn.ctc_greedy_decode(logits[:, :, :4], "あいう") == \
        ctc_greedy_decode(logits[:, :, :4], "あいう")


@pytest.mark.parametrize("files,recognizer", [
    ((), "latin_g2"),
    (("latin_g2.pth",), "latin_g2"),
    (("english_g2.pth",), "latin_g2"),
    (("english_g2.pth", "latin_g2_chars.txt"), "latin_g2"),
    (("japanese_g2.pth",), "japanese_g2"),  # no sidecar: falls back to latin
    (("japanese_g2.pth", "japanese_g2_chars.txt", "craft_mlt_25k.pth"), "japanese_g2"),
    (("craft_mlt_25k.pth", "latin_g2.pth"), "japanese_g2"),  # no japanese model
])
def test_checkpoint_fallbacks_match_jax(tmp_path, files, recognizer, craft_tree):
    rng = np.random.default_rng(9)
    for name in files:
        if name.endswith("_chars.txt"):
            (tmp_path / name).write_text("あ\nい\nう\n" if "japanese" in name
                                         else "abcdef\n", encoding="utf-8")
        elif name.startswith("craft"):
            torch.save(port_craft.from_jax_params(craft_tree).state_dict(),
                       str(tmp_path / name))
        else:
            n_cls = 4 if "japanese" in name else None
            torch.save({k: torch.from_numpy(v) for k, v in _easyocr_recognizer_sd(
                rng, channels=64, hidden=16, n_cls=n_cls).items()}, str(tmp_path / name))
    _, jcrnn, jcharset, jpre = jax_weights.load_ocr_checkpoints(str(tmp_path), recognizer)
    _, pcrnn, pcharset, ppre = port_weights.load_ocr_checkpoints(str(tmp_path), recognizer)
    assert (pcharset, ppre) == (jcharset, jpre)
    assert pcrnn.Prediction.weight.shape[0] == np.asarray(jcrnn["fc"]["w"]).shape[1]
    for lang in ("ja", "EN", "ru", "xx", "hi"):
        assert port_weights.recognizer_for_language(lang) == \
            jax_weights.recognizer_for_language(lang)


# ---------------------------------------------------------------------------
# the pipeline

def use_small_detector(monkeypatch) -> None:
    """Both packages' OCR at a SMALL_H x SMALL_W detector input."""
    from eioku_tpu_torch.ml import combined as port_combined

    for module in (jax_ocr, ocr_task, port_combined):
        monkeypatch.setattr(module, "DETECT_H", SMALL_H)
        monkeypatch.setattr(module, "DETECT_W", SMALL_W)


def _write_text_clip(path: str) -> None:
    """4 s at 10 fps of dark text on a light ground, at the detector input
    of `use_small_detector`, so the standalone task and the fold give CRAFT
    the same frames."""
    import cv2

    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (SMALL_W, SMALL_H))
    assert w.isOpened()
    for f in range(40):
        frame = np.full((SMALL_H, SMALL_W, 3), 235, np.uint8)
        cv2.putText(frame, "EIOKU %d" % (f // 20), (10 + f, 40),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (20, 20, 20), 2)
        cv2.putText(frame, "search", (30, 80), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (10, 10, 80), 2)
        w.write(frame)
    w.release()


@pytest.fixture(scope="module")
def text_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_ocr") / "text.mp4")
    _write_text_clip(path)
    return path


def write_ocr_checkpoints(directory) -> None:
    """craft_mlt_25k.pth and latin_g2.pth in EasyOCR's layout: the JAX
    package's seeded trees (seed 0), the CRAFT head's biases shifted by
    HEAD_SHIFT."""
    craft_tree, crnn_tree = seeded_trees()
    sd = port_craft.from_jax_params(craft_tree).state_dict()
    sd["conv_cls.8.bias"] = sd["conv_cls.8.bias"] + torch.tensor(HEAD_SHIFT)
    torch.save(sd, str(directory / "craft_mlt_25k.pth"))
    torch.save(port_crnn.from_jax_params(crnn_tree).state_dict(),
               str(directory / "latin_g2.pth"))


@pytest.fixture(scope="module")
def ocr_cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ocr_models")
    write_ocr_checkpoints(d)
    return str(d)


def _top2_gap(logits: np.ndarray) -> float:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _check_margins(frames: np.ndarray, cache: str) -> int:
    """On these detector-input frames: the two packages' CRAFT maps within
    MAP_TOL, no map value within MAP_TOL of a threshold where it decides a
    component (every value against 0.4, each component's peak region score
    against 0.7), and on the crops both cut, logits within LOGIT_TOL whose
    top-1 leads by more than twice their difference at every step. Returns
    the number of crops."""
    import cv2

    jcraft, jcrnn, _, jpre = jax_ocr._models(cache, "latin_g2")
    craft, crnn, _, pre = ocr_task._models(cache, "latin_g2", CPU)
    assert pre and jpre
    # one batch of OCR_CONFIG's size, as the runs use (one JAX compile)
    n = len(frames)
    batch = np.concatenate([frames, np.zeros((4 - n,) + frames.shape[1:], frames.dtype)])
    jmaps = np.asarray(jax_ocr.craft_scores_i420(jcraft, jnp.asarray(to_i420(batch))))[:n]
    pmaps = ocr_task.craft_scores_i420(craft, torch.from_numpy(to_i420(batch))).numpy()[:n]
    assert np.abs(pmaps - jmaps).max() <= MAP_TOL
    # low_text and link_threshold (0.4) decide every pixel's membership;
    # text_threshold (0.7) only compares each component's largest region
    # score
    margin = float(np.abs(jmaps - 0.4).min())
    for frame, m in zip(frames, jmaps):
        labels, n = ndimage.label((m[..., 0] >= 0.4) | (m[..., 1] >= 0.4))
        if n:
            peaks = ndimage.maximum(m[..., 0], labels, np.arange(1, n + 1))
            margin = min(margin, float(np.abs(np.asarray(peaks) - 0.7).min()))
    assert margin > MAP_TOL, f"a map value lies {margin} from a threshold"
    n = 0
    for frame, m in zip(frames, jmaps):
        gray = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        crops, _ = ocr_task.detect_text_crops(gray, m[..., 0], m[..., 1])
        by_bucket: dict[int, list] = {}
        for c in crops:  # recognize_crops' batches (the runs' JAX compiles)
            by_bucket.setdefault(ocr_task._bucket_width(c.shape[1]), []).append(c)
        for bucket, group in by_bucket.items():
            batch = ocr_task.crop_batch(group, bucket)
            want = np.asarray(crnn_forward(jcrnn, jnp.asarray(batch.transpose(0, 2, 3, 1))))
            with torch.no_grad():
                got = crnn(torch.from_numpy(batch)).numpy()
            for g, w in zip(got, want):
                diff = float(np.abs(g - w).max())
                assert diff <= LOGIT_TOL
                # no argmax can flip where the top-1 leads by more than
                # twice the largest difference between the packages' logits
                assert _top2_gap(w) > 2 * diff
        n += len(crops)
    return n


def _assert_rows_equal(port_rows, jax_rows):
    """Equal rows; the confidences (means of softmax probabilities) within
    1e-6."""
    assert len(port_rows) == len(jax_rows)
    for p, j in zip(port_rows, jax_rows):
        assert abs(p["payload"]["confidence"] - j["payload"]["confidence"]) <= 1e-6
        strip = lambda r: {**r, "payload": {k: v for k, v in r["payload"].items()  # noqa: E731
                                            if k != "confidence"}}
        assert strip(p) == strip(j)


def test_run_ocr_rows_equal_jax(text_clip, ocr_cache, monkeypatch):
    use_small_detector(monkeypatch)
    frames = np.concatenate([b.frames[:b.valid] for b in video_io.iter_frame_batches(
        text_clip, batch_size=4, frame_interval_s=2.0, resize_hw=(SMALL_H, SMALL_W),
        fast_level=0)])
    assert _check_margins(frames, ocr_cache) >= 4
    want = jax_ocr.run_ocr(text_clip, OCR_CONFIG, ocr_cache)
    got = InferenceEngine(model_cache_dir=ocr_cache, device="cpu").run_task(
        "ocr", text_clip, OCR_CONFIG)
    assert len(got) >= 4
    assert {r["payload"]["frame_index"] for r in got} == {0, 20}
    assert all(r["payload"]["languages"] == ["en"] for r in got)
    _assert_rows_equal(got, want)


@pytest.mark.parametrize("config", [
    {"ocr": {"languages": ["en", "fr"], "batch_size": 4}},
    {"scene_detection": {"sample_fps": 2.0},
     "ocr": {"languages": ["en", "ru"], "batch_size": 4}},
], ids=["ocr only", "with scenes, two recognizer groups"])
def test_visual_analysis_ocr_fold_rows_equal_jax(config, text_clip, ocr_cache,
                                                 monkeypatch):
    import cv2

    use_small_detector(monkeypatch)
    config = {**config, "decode_fast": 0}
    want = jax_visual_analysis(text_clip, config, model_cache_dir=ocr_cache)
    got = run_visual_analysis(text_clip, config, model_cache_dir=ocr_cache, device="cpu")
    assert set(got) == set(want)
    # the fold's detector input on its OCR grid: the decode-scale frame
    # resized to the detector's input
    frames = np.stack([cv2.resize(b.frames[i], (SMALL_W, SMALL_H),
                                  interpolation=cv2.INTER_AREA)
                       for b in video_io.iter_frame_batches(
                           text_clip, batch_size=4,
                           frame_interval_s=2.0,
                           fast_level=0)
                       for i in range(b.valid)])
    assert _check_margins(frames, ocr_cache) >= 4
    _assert_rows_equal(got["ocr"], want["ocr"])
    langs = [r["payload"]["languages"] for r in got["ocr"]]
    groups = [["en", "fr"]] if "scene_detection" not in config else [["en"], ["ru"]]
    assert sorted(map(tuple, {tuple(x) for x in langs})) == sorted(map(tuple, groups))
    if "scene_detection" in config:
        assert got["scene_detection"] == want["scene_detection"]
