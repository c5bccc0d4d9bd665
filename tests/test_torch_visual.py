"""The PyTorch port's CLIP towers and visual index against the JAX package
(CPU, fp32).

- quick_gelu, both towers at tests/test_clip.py's TINY config (the JAX
  package's seeded tree carried over with `from_jax_params`) within 1e-5,
  the HF converter (both spellings of the vision pre-LN), `load_clip` from
  a cache file, `preprocess_images` and the BPE tokenizer equal.
- `VisualIndex` against the JAX package's on two databases built alike:
  the same frame_embeddings rows (stride and scene-midpoint keyframes,
  `max_keyframes`, re-indexing, a full and a partial keyframe cache), the
  same vector files within f16 rounding, and the same `search` and
  `similar` hits. Random TINY weights embed the test clips' keyframes at
  distinct scores (gaps above 1e-4 where hits are ranked), and every clip
  differs from the others, so no two vectors tie: each ranked list is
  asserted to have those gaps before its order is compared.
"""
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.api.app import build_context as jax_build_context
from eioku_tpu.config.settings import AppConfig as JaxAppConfig
from eioku_tpu.db.connection import Database as JaxDatabase
from eioku_tpu.domain.artifacts import ArtifactEnvelope as JaxEnvelope
from eioku_tpu.domain.models import Video as JaxVideo
from eioku_tpu.index.visual import VisualIndex as JaxVisualIndex
from eioku_tpu.models.clip import model as jax_clip
from eioku_tpu.models.clip.tokenizer import ClipTokenizer as JaxClipTokenizer
from eioku_tpu.models.clip.tokenizer import FallbackClipTokenizer as JaxFallback
from eioku_tpu_torch.api.app import build_context
from eioku_tpu_torch.config.settings import AppConfig
from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import ArtifactEnvelope
from eioku_tpu_torch.domain.models import Video
from eioku_tpu_torch.index.visual import VisualIndex
from eioku_tpu_torch.models.clip import model as port_clip
from eioku_tpu_torch.models.clip.tokenizer import ClipTokenizer, FallbackClipTokenizer
from eioku_tpu_torch.models.layers import load_state, quick_gelu
from test_clip import TINY, _tiny_vocab_files

PORT_TINY = port_clip.ClipConfig(**{k: getattr(TINY, k) for k in TINY.__dataclass_fields__})
TOL = 1e-5
SCORE_TOL = 1e-5  # a search score, port vs JAX (f16 corpus, fp32 sums)
GAP = 1e-4  # ranked hits are compared where neighbours differ by more


@pytest.fixture(scope="module")
def params():
    return jax_clip.init_clip_params(TINY, seed=0)


@pytest.fixture(scope="module")
def port_model(params):
    sd = port_clip.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return load_state(port_clip.CLIP(PORT_TINY), sd).eval()


# ---------------------------------------------------------------------------
# the model

def test_quick_gelu_matches_jax():
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    want = np.asarray(jax_clip._quick_gelu(jnp.asarray(x)))
    np.testing.assert_allclose(quick_gelu(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=1e-6)


def test_image_tower_matches_jax(params, port_model):
    imgs = np.random.default_rng(0).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_clip.clip_encode_image(params, jnp.asarray(imgs), TINY))
    got = port_clip.clip_encode_image(port_model, torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, TINY.embed_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _ids() -> np.ndarray:
    """SOT ... EOT rows with zero padding, and one row with garbage after
    its EOT (pooling must take the first EOT: the largest id)."""
    ids = np.zeros((3, 77), np.int32)
    ids[0, :5] = [998, 5, 6, 7, 999]
    ids[1, :3] = [998, 10, 999]
    ids[2, :77] = np.random.default_rng(1).integers(1, 990, 77)
    ids[2, 0], ids[2, 30] = 998, 999
    return ids


def test_text_tower_matches_jax(params, port_model):
    ids = _ids()
    want = np.asarray(jax_clip.clip_encode_text(params, jnp.asarray(ids), TINY))
    got = port_clip.clip_encode_text(port_model, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(np.linalg.norm(got, axis=-1) - 1).max() < 1e-5


def _hf_state_dict(port_model, pre_ln_key: str) -> dict:
    """The port's state dict in HF CLIPModel naming with a shifted copy of
    every weight, plus HF's extra keys."""
    rng = np.random.default_rng(2)
    sd = {}
    for k, v in port_model.state_dict().items():
        v = v.numpy() + rng.standard_normal(v.shape).astype(np.float32) * 0.01
        sd[k.replace("vision_model.pre_layrnorm", pre_ln_key)] = torch.from_numpy(v)
    sd["logit_scale"] = torch.tensor(4.6)
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    return sd


@pytest.mark.parametrize("pre_ln_key", ["vision_model.pre_layrnorm",
                                        "vision_model.pre_layernorm"])
def test_hf_converter_matches_jax(pre_ln_key, port_model):
    sd = _hf_state_dict(port_model, pre_ln_key)
    jparams = jax_clip.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()}, TINY)
    model = load_state(port_clip.CLIP(PORT_TINY),
                                 port_clip.convert_hf_state_dict(sd, PORT_TINY))
    imgs = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        port_clip.clip_encode_image(model, torch.from_numpy(imgs)).numpy(),
        np.asarray(jax_clip.clip_encode_image(jparams, jnp.asarray(imgs), TINY)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        port_clip.clip_encode_text(model, torch.from_numpy(_ids())).numpy(),
        np.asarray(jax_clip.clip_encode_text(jparams, jnp.asarray(_ids()), TINY)),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["clip-vit-b32/pytorch_model.bin", "clip.bin", None])
def test_load_clip_reads_the_cache_like_jax(name, tmp_path, port_model):
    if name is not None:
        path = tmp_path / name
        path.parent.mkdir(exist_ok=True)
        torch.save(_hf_state_dict(port_model, "vision_model.pre_layrnorm"), str(path))
    jparams, _, jpre = jax_clip.load_clip(str(tmp_path), TINY)
    model, cfg, pre = port_clip.load_clip(str(tmp_path), PORT_TINY)
    assert pre == jpre == (name is not None) and cfg == PORT_TINY
    if pre:
        np.testing.assert_allclose(
            port_clip.clip_encode_text(model, torch.from_numpy(_ids())).numpy(),
            np.asarray(jax_clip.clip_encode_text(jparams, jnp.asarray(_ids()), TINY)),
            rtol=0, atol=TOL)
    else:  # random init: unit-norm outputs of the right width
        out = port_clip.clip_encode_text(model, torch.from_numpy(_ids())).numpy()
        assert out.shape == (3, TINY.embed_dim)


def test_full_width_config_and_keys():
    cfg = port_clip.ClipConfig()
    assert cfg == port_clip.ClipConfig(**{k: getattr(jax_clip.ClipConfig(), k)
                                          for k in jax_clip.ClipConfig.__dataclass_fields__})
    with torch.device("meta"):
        sd = port_clip.CLIP(cfg).state_dict()
    assert tuple(sd["vision_model.embeddings.patch_embedding.weight"].shape) == \
        (768, 3, 32, 32)
    assert tuple(sd["vision_model.embeddings.position_embedding.weight"].shape) == (50, 768)
    assert tuple(sd["text_model.embeddings.token_embedding.weight"].shape) == (49408, 512)
    assert "vision_model.pre_layrnorm.weight" in sd and "visual_projection.bias" not in sd
    assert sum(v.numel() for v in sd.values()) == 151_277_312


@pytest.mark.parametrize("hw", [(64, 64), (48, 100), (200, 90), (30, 30)])
def test_preprocess_images_matches_jax(hw):
    frames = [np.random.default_rng(hw[0]).integers(0, 255, (*hw, 3), np.uint8)
              for _ in range(2)]
    np.testing.assert_array_equal(port_clip.preprocess_images(frames, PORT_TINY),
                                  jax_clip.preprocess_images(frames, TINY))


def test_tokenizers_match_jax(tmp_path):
    vocab, merges = _tiny_vocab_files(tmp_path)
    texts = ["Hello world", "hello  WORLD!!", "", "it's a dog's life_", "héllo 42"]
    ours, theirs = ClipTokenizer.from_files(vocab, merges), \
        JaxClipTokenizer.from_files(vocab, merges)
    np.testing.assert_array_equal(ours.encode_batch(texts), theirs.encode_batch(texts))
    np.testing.assert_array_equal(FallbackClipTokenizer(TINY.vocab_size).encode_batch(texts),
                                  JaxFallback(TINY.vocab_size).encode_batch(texts))


# ---------------------------------------------------------------------------
# the visual index

def _write_clip(path: str, n_frames: int, seed: int) -> None:
    """A 10 fps 64x64 clip of colour blocks that change every few frames,
    different for each seed."""
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
    assert w.isOpened()
    frame = None
    for i in range(n_frames):
        if i % 5 == 0:
            frame = np.kron(rng.integers(0, 255, (4, 4, 3)),
                            np.ones((16, 16, 1))).astype(np.uint8)
        w.write(frame)
    w.release()


class Pair:
    """One context and visual index per package, on databases built alike."""

    def __init__(self, tmp, params, port_model):
        self.jax_ctx = jax_build_context(
            JaxAppConfig(scan_paths=[], auto_discover=False, semantic_search=False,
                         visual_search=False),
            db=JaxDatabase(f"sqlite:///{tmp}/jax.db"))
        self.ctx = build_context(
            AppConfig(scan_paths=[], auto_discover=False, semantic_search=False,
                      visual_search=False),
            db=Database(f"sqlite:///{tmp}/port.db"))
        self.jax = JaxVisualIndex(self.jax_ctx, data_dir=str(tmp / "jax_index"))
        self.jax._params, self.jax._cfg = params, TINY
        self.jax._tokenizer = JaxFallback(TINY.vocab_size)
        self.port = VisualIndex(self.ctx, data_dir=str(tmp / "port_index"), device="cpu")
        self.port._model, self.port._cfg, self.port._dev = port_model, PORT_TINY, \
            torch.device("cpu")
        self.port._tokenizer = FallbackClipTokenizer(TINY.vocab_size)
        self.tmp = tmp

    def add_video(self, vid: str, n_frames: int, seed: int, duration_ms=None) -> str:
        path = str(self.tmp / f"{vid}.mp4")
        _write_clip(path, n_frames, seed)
        self.jax_ctx.videos.save(JaxVideo(id=vid, path=path, file_hash=vid,
                                          duration_ms=duration_ms))
        self.ctx.videos.save(Video(id=vid, path=path, file_hash=vid,
                                   duration_ms=duration_ms))
        return path

    def add_scenes(self, vid: str, spans) -> None:
        for ctx, env in ((self.jax_ctx, JaxEnvelope), (self.ctx, ArtifactEnvelope)):
            ctx.artifacts.batch_create([env(
                artifact_id=f"{vid}_scene_{i}", asset_id=vid, artifact_type="scene",
                schema_version=1, span_start_ms=s, span_end_ms=e,
                payload_json={"scene_index": i, "start_ms": s, "end_ms": e,
                              "duration_ms": e - s},
                producer="p", producer_version="1", model_profile="balanced",
                config_hash="c", input_hash="i", run_id="r1")
                for i, (s, e) in enumerate(spans)])

    def index(self, vid: str, config: dict) -> int:
        n = self.jax.index_video(vid, config)
        assert self.port.index_video(vid, config) == n
        return n

    def assert_same_index(self) -> None:
        sql = ("SELECT slot, asset_id, ts_ms, scene_index, model FROM frame_embeddings "
               "ORDER BY slot")
        rows = [tuple(r) for r in self.ctx.db.query(sql)]
        assert rows == [tuple(r) for r in self.jax_ctx.db.query(sql)] and rows
        got = np.fromfile(self.port.vec_path, np.float16).astype(np.float32)
        want = np.fromfile(self.jax.vec_path, np.float16).astype(np.float32)
        assert got.shape == want.shape
        # f16 rounding of fp32 values within TOL: at most one f16 ulp apart
        assert np.abs(got - want).max() <= 2 ** -10
        with open(self.port.meta_path) as f, open(self.jax.meta_path) as g:
            assert f.read() == g.read()


@pytest.fixture()
def pair(tmp_path, params, port_model):
    return Pair(tmp_path, params, port_model)


def _assert_same_hits(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    scores = [h["score"] for h in want]
    assert all(a - b > GAP for a, b in zip(scores, scores[1:])), scores
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= SCORE_TOL
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}


def test_index_search_and_similar_match_jax(pair):
    pair.add_video("a", 30, seed=0)
    pair.add_video("b", 40, seed=1)
    assert pair.index("a", {"keyframe_interval_s": 1.0}) == 3
    assert pair.index("b", {"keyframe_interval_s": 1.0}) == 4
    pair.assert_same_index()
    for query, top_k, asset in (("a red car", 5, None), ("night", 7, None),
                                ("beach", 3, "b")):
        _assert_same_hits(pair.port.search(query, top_k=top_k, asset_id=asset),
                          pair.jax.search(query, top_k=top_k, asset_id=asset))
    hits = pair.port.similar("a", 1400, top_k=6)
    _assert_same_hits(hits, pair.jax.similar("a", 1400, top_k=6))
    assert len(hits) == 6 and ("a", 1500) not in {(h["video_id"], h["ts_ms"]) for h in hits}
    assert pair.port.similar("nope", 0) == pair.jax.similar("nope", 0) == []


def test_reindex_replaces_slots_like_jax(pair):
    pair.add_video("a", 30, seed=0)
    pair.add_video("b", 20, seed=2)
    pair.index("a", {"keyframe_interval_s": 0.5})
    pair.index("b", {"keyframe_interval_s": 0.5})
    n = pair.index("a", {"keyframe_interval_s": 0.5})
    pair.assert_same_index()
    assert pair.ctx.db.scalar("SELECT MIN(slot) FROM frame_embeddings WHERE "
                              "asset_id='a'") == 10  # a's first 6 slots are stale
    # stale slots never resolve: the search escalates k over them
    got = pair.port.search("x", top_k=n + 10)
    _assert_same_hits(got, pair.jax.search("x", top_k=n + 10))
    assert len(got) == n + 4


def test_scene_midpoints_and_max_keyframes_like_jax(pair):
    pair.add_video("s", 30, seed=3, duration_ms=3000)
    pair.add_scenes("s", [(0, 1000), (1000, 2200), (2200, 3000)])
    pair.add_video("m", 40, seed=4)
    assert pair.index("s", {}) == 3
    assert pair.index("m", {"keyframe_interval_s": 0.1, "max_keyframes": 5}) == 5
    pair.assert_same_index()
    rows = [tuple(r) for r in pair.ctx.db.query(
        "SELECT ts_ms, scene_index FROM frame_embeddings WHERE asset_id='s' ORDER BY slot")]
    assert rows == [(500, 0), (1600, 1), (2600, 2)]


@pytest.mark.parametrize("cached", ["full", "partial"])
def test_keyframe_cache_like_jax(cached, pair, monkeypatch):
    pair.add_video("k", 30, seed=5, duration_ms=3000)
    stamps = (200, 1300, 2400) if cached == "full" else (500,)
    for index in (pair.port, pair.jax):
        d = index.keyframe_cache_dir("k")
        os.makedirs(d)
        for ts in stamps:
            block = np.kron(np.random.default_rng(ts).integers(0, 255, (4, 4, 3)),
                            np.ones((8, 8, 1))).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{ts}.jpg"), block)
    decoded = {}
    for name, index in (("port", pair.port), ("jax", pair.jax)):
        calls = []
        fn = index._decode_at
        monkeypatch.setattr(index, "_decode_at",
                            lambda path, st, fn=fn, calls=calls: calls.append(st) or fn(path, st))
        decoded[name] = calls
    assert pair.index("k", {"keyframe_interval_s": 1.0}) == 3
    assert decoded["port"] == decoded["jax"]
    # 500.jpg is within the 1500 ms tolerance of the stamps 500 and 1500
    assert decoded["port"] == ([] if cached == "full" else [[(2500, None)]])
    pair.assert_same_index()


def test_index_on_a_host_without_cuda(tmp_path, monkeypatch):
    """device None is CUDA, resolved at first use: the index builds without a
    card and raises only when it needs the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = build_context(AppConfig(scan_paths=[], auto_discover=False, semantic_search=False,
                                  visual_search=True, model_cache_dir=str(tmp_path)),
                        db=Database(f"sqlite:///{tmp_path}/c.db"))
    index = ctx.extra["visual_index"]
    assert isinstance(index, VisualIndex) and index.device is None
    assert index.search("anything") == []  # no vectors yet: no device needed
    with pytest.raises(RuntimeError, match="CUDA"):
        index.embed_texts(["a dog"])
