"""The port's semantic layer against the JAX package's (CPU): chunking,
topics, the cosine top-k, k-means and the IVF index, SemanticIndex end to
end on both retrieval routes, rebuild, and the cross-encoder reranker.

Both packages read the same checkpoints, written here from seeded trees.
The JAX SemanticIndex and Reranker always run their trunks in bf16
(eioku_tpu/index/semantic.py:130, rerank.py:68); the port's run fp32 on the
CPU. So the end-to-end comparisons hold hits and orders, not bits: at every
rank whose score is more than SCORE_TOL from its neighbours' the same
video, text, source and jump_to, and every score within SCORE_TOL of the
JAX one. Functions that see the same inputs on both sides (chunking, top-k,
k-means with the same seeds, the IVF layout) are compared exactly or
within fp32 rounding.
"""
import numpy as np
import pytest
import torch

import jax

from eioku_tpu.api.app import build_context as jax_build_context
from eioku_tpu.config.settings import AppConfig as JaxAppConfig
from eioku_tpu.db.connection import Database as JaxDatabase
from eioku_tpu.domain.artifacts import ArtifactEnvelope as JaxEnvelope
from eioku_tpu.domain.models import Video as JaxVideo
from eioku_tpu.index import ivf as jivf
from eioku_tpu.index import semantic as jsem
from eioku_tpu.index.rerank import Reranker as JaxReranker
from eioku_tpu.models.checkpoint import save_params
from eioku_tpu.models.embed import cross_encoder as jce
from eioku_tpu.models.embed import minilm as jml
from eioku_tpu.ops import quant as jquant
from eioku_tpu_torch.api.app import build_context
from eioku_tpu_torch.config.settings import AppConfig
from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.domain.artifacts import ArtifactEnvelope
from eioku_tpu_torch.domain.models import Video
from eioku_tpu_torch.index import ivf as pivf
from eioku_tpu_torch.index import semantic as psem
from eioku_tpu_torch.index.rerank import Reranker
from eioku_tpu_torch.models.embed import cross_encoder as pce
from eioku_tpu_torch.models.layers import QuantLinear

# JAX bf16 trunk against the port's fp32 one: the score of a hit may move
# by this much (worst seen when this test was written: 1.46e-3)
SCORE_TOL = 2e-2
# rerank logits of the same candidates, bf16 against fp32 (they spread over
# about 2; worst seen when this test was written: 1.67e-2)
LOGIT_TOL = 5e-2

TOPICS = ["harbour boat sail anchor tide wave dock fishing net gull".split(),
          "kitchen recipe oven pasta garlic tomato basil flour bread butter".split(),
          "concert guitar drum stage singer chorus melody amplifier crowd encore".split(),
          "mountain hiking trail summit snow glacier ridge valley pine boulder".split()]
N_SEGMENTS, N_CLUSTERS = 24, 4  # IvfIndex.build's k for 24 vectors: max(sqrt(24), 4)
DUPLICATE = (7, 3)  # segment 7 repeats segment 3's text: an exact score tie


# -- chunking, top-k, k-means, IVF --------------------------------------------------------


SEGMENTS = [{"text": t, "start_ms": i * 1000, "end_ms": (i + 1) * 1000}
            for i, t in enumerate(["segment zero text here", "", "  one  ",
                                   "a much longer segment " * 5, "short", "tail end"]
                                  + [f"segment {i} words" for i in range(6, 20)])]


@pytest.mark.parametrize("chunk_chars,overlap", [(400, 80), (60, 20), (20, 0), (30, 100)])
def test_chunk_segments_as_jax(chunk_chars, overlap):
    assert psem.chunk_segments(SEGMENTS, chunk_chars, overlap) == \
        jsem.chunk_segments(SEGMENTS, chunk_chars, overlap)


@pytest.mark.parametrize("case", ["ties", "all_equal", "neg_inf", "k_above_n"])
def test_top_k_breaks_ties_as_lax(case):
    rng = np.random.default_rng(3)
    scores = np.round(rng.standard_normal(300), 1).astype(np.float32)  # many ties
    k = 25
    if case == "all_equal":
        scores[:] = 0.5
    elif case == "neg_inf":
        scores[::3] = -np.inf
        k = 250
    elif case == "k_above_n":
        scores, k = scores[:7], 10
    got_s, got_i = pivf.top_k(torch.from_numpy(scores), k)
    want_s, want_i = jax.lax.top_k(scores, min(k, len(scores)))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("k", [1, 10, 37])
def test_topk_cosine_as_jax_with_ties(k):
    rng = np.random.default_rng(k)
    v = rng.standard_normal((500, 384)).astype(np.float32)
    v[100:120] = v[7]  # duplicated rows score exactly alike
    v[300] = v[7]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    corpus = v.astype(np.float16)
    q = v[7] + 0.05 * rng.standard_normal(384).astype(np.float32)
    got_s, got_i = psem._topk_cosine(torch.from_numpy(corpus), torch.from_numpy(q), k)
    want_s, want_i = jsem._topk_cosine(corpus, q, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6, rtol=0)
    if k > 1:
        assert got_i[0] == 7 and got_i[1] == 100  # the tie: lower index first


def _clustered(n=2000, d=64, n_clusters=16, seed=0):
    """tests/test_ivf.py's clustered vectors, with one true cluster per
    k-means seed: the JAX package's seeds for k = n_clusters fall on
    distinct clusters, so no centroid splits a cluster, where points near
    the split would tie to within the two packages' fp32 rounding."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3
    assign = rng.integers(0, n_clusters, n)
    assign[_jax_seeds(n, n_clusters)] = np.arange(n_clusters)
    v = centers[assign] + rng.standard_normal((n, d)).astype(np.float32) * 0.3
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _jax_seeds(n: int, k: int, seed: int = 0) -> np.ndarray:
    """The seeds the JAX package's kmeans draws (eioku_tpu/index/ivf.py:29-31)."""
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False))


@pytest.fixture()
def jax_seeds(monkeypatch):
    """The port's k-means seeded as the JAX package's (hazard a)."""
    monkeypatch.setattr(pivf, "_seed_indices", lambda n, k, seed, device: torch.tensor(
        _jax_seeds(n, k, seed), device=device))


def test_seed_indices_are_distinct_and_reproducible():
    a = pivf._seed_indices(50, 20, 3, torch.device("cpu"))
    assert len(set(a.tolist())) == 20 and int(a.min()) >= 0 and int(a.max()) < 50
    assert torch.equal(a, pivf._seed_indices(50, 20, 3, torch.device("cpu")))


@pytest.mark.parametrize("iters", [1, 10])
def test_kmeans_as_jax_with_the_same_seeds(jax_seeds, iters):
    v = _clustered()
    got = pivf.kmeans(torch.from_numpy(v), k=16, iters=iters).numpy()
    want = np.asarray(jivf.kmeans(jax.numpy.asarray(v), k=16, iters=iters))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture()
def ivf_pair(jax_seeds):
    v = _clustered(n=1500, n_clusters=38, seed=1) * 2.0  # k = sqrt(1500); build normalises
    return v, pivf.IvfIndex.build(v), jivf.IvfIndex.build(v)


def test_ivf_build_layout_as_jax(ivf_pair):
    _, got, want = ivf_pair
    assert got.k == want.k == int(np.sqrt(1500)) and got.n_vectors == want.n_vectors
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.slot_map.numpy(), np.asarray(want.slot_map))
    # the same rows, normalised by each package (fp32 rounding apart)
    np.testing.assert_allclose(got.blocks.numpy(), np.asarray(want.blocks),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("n_probe", [None, 1, 9, 38])
def test_ivf_search_as_jax(ivf_pair, n_probe):
    v, got_index, want_index = ivf_pair
    rng = np.random.default_rng(4)
    for q in v[rng.integers(0, len(v), 5)] + 0.1 * rng.standard_normal((5, 64)):
        got_s, got_slots = got_index.search(q, top_k=10, n_probe=n_probe)
        want_s, want_slots = want_index.search(q, top_k=10, n_probe=n_probe)
        np.testing.assert_array_equal(got_slots, want_slots)
        np.testing.assert_allclose(got_s, want_s, atol=1e-5, rtol=0)


def test_ivf_build_clamps_k_to_the_corpus():
    v = _clustered(n=2, n_clusters=2)
    index = pivf.IvfIndex.build(v)
    scores, slots = index.search(v[0], top_k=1)
    assert index.k == 2 and slots[0] == 0 and scores[0] == pytest.approx(1.0, abs=1e-5)


# -- SemanticIndex end to end ------------------------------------------------------------


def _topic_labels() -> np.ndarray:
    """A topic per segment, such that the JAX package's k-means seeds (which
    the port is given too) fall on distinct topics: with the topics well
    apart, both packages' k-means then settle on the topics, and the IVF
    route probes the same cluster whatever the bf16 rounding."""
    seeds = _jax_seeds(N_SEGMENTS, N_CLUSTERS)
    labels = np.full(N_SEGMENTS, -1)
    labels[seeds] = np.arange(N_CLUSTERS)
    rest = np.flatnonzero(labels < 0)
    labels[rest] = np.arange(len(rest)) % N_CLUSTERS
    return labels


def _segment_texts() -> list[str]:
    rng = np.random.default_rng(0)
    labels = _topic_labels()
    texts = [" ".join(rng.permutation(TOPICS[t])[:8]) for t in labels]
    dup, src = DUPLICATE
    if labels[dup] != labels[src]:
        raise AssertionError("the duplicate must share its source's topic")
    texts[dup] = texts[src]
    return texts


def _write_minilm(cache) -> None:
    """A seeded full-width MiniLM whose token embeddings are scaled up, so
    that its embeddings tell the topics apart (the 0.05-scaled random init
    maps every text to cosine ~0.998 of every other)."""
    params = jml.init_minilm_params(jml.MiniLMConfig(), seed=1)
    params["tok_emb"] = params["tok_emb"] * 100.0
    save_params(params, str(cache / "minilm-l6" / "native.npz"))


class _Pkg:
    def __init__(self, name, build_context, config_cls, database_cls, envelope_cls,
                 video_cls, sem, ivf, **index_kw):
        self.name, self.build_context, self.config_cls = name, build_context, config_cls
        self.database_cls, self.envelope_cls, self.video_cls = \
            database_cls, envelope_cls, video_cls
        self.sem, self.ivf, self.index_kw = sem, ivf, index_kw


JAX = _Pkg("jax", jax_build_context, JaxAppConfig, JaxDatabase, JaxEnvelope, JaxVideo,
           jsem, jivf)
PORT = _Pkg("port", build_context, AppConfig, Database, ArtifactEnvelope, Video, psem,
            pivf, device="cpu")

QUERIES = {"segment_0": 0, "duplicate": DUPLICATE[1], "segment_13": 13}
MIXED_QUERY = "harbour boat kitchen oven trail"
VIDEO = "video-1"


def _context(pkg: _Pkg, tmp, cache):
    cfg = pkg.config_cls(scan_paths=[], semantic_search=False, visual_search=False,
                         model_cache_dir=str(cache), index_dir=str(tmp / "idx"))
    ctx = pkg.build_context(cfg, db=pkg.database_cls(f"sqlite:///{tmp}/{pkg.name}.db"))
    ctx.videos.save(pkg.video_cls(id=VIDEO, path=str(tmp / "v.mp4")))
    return ctx


def _write_transcript(pkg: _Pkg, ctx, texts: list[str]) -> None:
    ctx.artifacts.batch_create([pkg.envelope_cls(
        artifact_id=f"seg-{i}", asset_id=VIDEO, artifact_type="transcript.segment",
        schema_version=1, span_start_ms=i * 3000, span_end_ms=(i + 1) * 3000,
        payload_json={"text": t, "language": "en", "start_ms": i * 3000,
                      "end_ms": (i + 1) * 3000},
        producer="p", producer_version="1", model_profile="balanced", config_hash="c",
        input_hash="i", run_id="r1") for i, t in enumerate(texts)])


def _searches(index, texts: list[str]) -> dict:
    out = {name: index.search(texts[i], top_k=6) for name, i in QUERIES.items()}
    out["mixed"] = index.search(MIXED_QUERY, top_k=6)
    out["filtered"] = index.search(texts[2], top_k=3, asset_id="no-such-video")
    return out


def _index_run(pkg: _Pkg, tmp, cache, texts) -> dict:
    ctx = _context(pkg, tmp, cache)
    _write_transcript(pkg, ctx, texts)
    index = pkg.sem.SemanticIndex(ctx, batch_size=8, **pkg.index_kw)
    n = index.index_video(VIDEO, {"chunk_chars": 20, "overlap_chars": 0})
    db = ctx.db
    out = {
        "chunks": n,
        "embedding_chunks": [tuple(r) for r in db.query(
            "SELECT slot, asset_id, start_ms, end_ms, text, source, model "
            "FROM embedding_chunks ORDER BY slot")],
        "artifacts": [(r["span_start_ms"], r["span_end_ms"], r["payload_json"])
                      for r in db.query("SELECT span_start_ms, span_end_ms, payload_json "
                                        "FROM artifacts WHERE artifact_type = "
                                        "'embedding.chunk' ORDER BY rowid")],
        "topics": [tuple(r) for r in db.query(
            "SELECT asset_id, label, score FROM topics ORDER BY score DESC, label")],
        "brute": _searches(index, texts),
    }
    with pytest.MonkeyPatch.context() as mp:  # hazard c: the IVF route at 24 vectors
        mp.setattr(pkg.sem.SemanticIndex, "IVF_THRESHOLD", 16)
        if pkg is PORT:
            mp.setattr(pivf, "_seed_indices", lambda n_, k, seed, device: torch.tensor(
                _jax_seeds(n_, k, seed), device=device))
        out["ivf"] = _searches(index, texts)
        out["ivf_k"] = index._ivf_cache.k
    out["rebuild"] = index.rebuild()
    out["rebuilt_rows"] = db.scalar("SELECT COUNT(*) FROM embedding_chunks")
    out["rebuilt_slots"] = [r[0] for r in db.query(
        "SELECT slot FROM embedding_chunks ORDER BY slot")]
    return out


@pytest.fixture(scope="module")
def index_runs(tmp_path_factory):
    cache = tmp_path_factory.mktemp("models")
    (cache / "minilm-l6").mkdir()
    _write_minilm(cache)
    texts = _segment_texts()
    return {pkg.name: _index_run(pkg, tmp_path_factory.mktemp(pkg.name), cache, texts)
            for pkg in (JAX, PORT)}


def test_index_writes_the_jax_rows(index_runs):
    got, want = index_runs["port"], index_runs["jax"]
    assert got["chunks"] == want["chunks"] == N_SEGMENTS
    assert got["embedding_chunks"] == want["embedding_chunks"]
    assert len(got["artifacts"]) == N_SEGMENTS
    for (gs, ge, gp), (ws, we, wp) in zip(got["artifacts"], want["artifacts"]):
        assert (gs, ge) == (ws, we)
        gp, wp = _payload(gp), _payload(wp)
        assert abs(gp.pop("norm") - wp.pop("norm")) <= 1e-3  # unit vectors
        assert gp == wp


def _payload(raw) -> dict:
    import json
    return json.loads(raw) if isinstance(raw, str) else dict(raw)


def test_index_writes_the_jax_topics(index_runs):
    assert index_runs["port"]["topics"] == index_runs["jax"]["topics"]
    assert len(index_runs["port"]["topics"]) == 10


def _hit_key(hit: dict) -> tuple:
    return hit["video_id"], hit["text"], hit["source"], hit["jump_to"]


def _assert_hits_agree(got: list, want: list) -> float:
    """The rule of the module docstring; the last hit serves only as its
    neighbour's neighbour. Returns the largest score difference."""
    assert len(got) == len(want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        worst = max(worst, abs(g["score"] - w["score"]))
        neighbours = [want[j]["score"] for j in (i - 1, i + 1) if 0 <= j < len(want)]
        if i < len(want) - 1 and all(abs(w["score"] - s) > SCORE_TOL for s in neighbours):
            assert _hit_key(g) == _hit_key(w), (i, g, w)
    assert worst <= SCORE_TOL
    return worst


@pytest.mark.parametrize("route", ["brute", "ivf"])
@pytest.mark.parametrize("query", sorted(QUERIES) + ["mixed"])
def test_search_hits_as_jax(index_runs, route, query):
    got = index_runs["port"][route][query]
    want = index_runs["jax"][route][query]
    assert got, "no hits"
    _assert_hits_agree(got, want)
    if query in QUERIES:  # a chunk's own text ranks it first, at cosine ~1
        assert got[0]["jump_to"]["start_ms"] == 3000 * QUERIES[query]
        assert got[0]["score"] == pytest.approx(1.0, abs=SCORE_TOL)


def test_search_takes_the_ivf_route_at_the_threshold(index_runs):
    for run in index_runs.values():
        assert run["ivf_k"] == N_CLUSTERS
        # n_probe = max(k // 8, 1) = 1: a query's hits are its topic's cluster
        labels = _topic_labels()
        hits = run["ivf"]["segment_13"]
        assert {labels[h["jump_to"]["start_ms"] // 3000] for h in hits} == {labels[13]}
        assert len(hits) == np.sum(labels == labels[13])


@pytest.mark.parametrize("route", ["brute", "ivf"])
def test_exact_ties_keep_the_lower_slot_first(index_runs, route):
    # the duplicated text scores exactly alike twice: both packages list
    # the earlier chunk (lower slot) first
    for run in index_runs.values():
        first, second = run[route]["duplicate"][:2]
        assert first["score"] == second["score"] and first["text"] == second["text"]
        assert [first["jump_to"]["start_ms"], second["jump_to"]["start_ms"]] == \
            [3000 * DUPLICATE[1], 3000 * DUPLICATE[0]]


def test_search_filters_by_asset(index_runs):
    assert index_runs["port"]["brute"]["filtered"] == [] == \
        index_runs["jax"]["brute"]["filtered"]


def test_rebuild_as_jax(index_runs):
    # rebuild re-indexes every video at the default chunking (400 chars,
    # overlap 80) and compacts: the slots start again at 0
    texts = _segment_texts()
    n = len(psem.chunk_segments([{"text": t, "start_ms": 0, "end_ms": 0} for t in texts]))
    got, want = index_runs["port"], index_runs["jax"]
    assert got["rebuild"] == want["rebuild"] == n > 1
    assert got["rebuilt_rows"] == want["rebuilt_rows"] == n
    assert got["rebuilt_slots"] == want["rebuilt_slots"] == list(range(n))


def test_search_escalates_past_stale_slots(tmp_path):
    # re-indexing leaves the first run's slots in the file, unmapped; a
    # search skips them and still returns top_k live hits
    cache = tmp_path / "models"
    cache.mkdir()
    ctx = _context(PORT, tmp_path, cache)
    texts = [" ".join(TOPICS[i % 4][:6]) + f" {i}" for i in range(6)]
    _write_transcript(PORT, ctx, texts)
    index = psem.SemanticIndex(ctx, batch_size=8, device="cpu")
    assert index.index_video(VIDEO, {"chunk_chars": 20, "overlap_chars": 0}) == 6
    assert index.index_video(VIDEO, {"chunk_chars": 20, "overlap_chars": 0}) == 6
    hits = index.search(texts[2], top_k=5)
    assert len(hits) == 5 and index._vector_count() == 12
    assert {h["artifact_id"] for h in hits} <= {r[0] for r in ctx.db.query(
        "SELECT artifact_id FROM embedding_chunks")}


# -- refusals ------------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["config", "env"])
def test_int8_embedder_matches_jax(tmp_path, monkeypatch, how):
    """embed_int8 (or EIOKU_EMBED_INT8=1) quantizes MiniLM's encoder layers,
    as the JAX package quantizes its `layers`. The JAX reference is its int8
    MiniLM at fp32 activations (hazard k) on the same ids: within 2e-3, the
    effect of an activation rounding one int8 step apart where the two
    packages' fp32 inputs straddle a .5 boundary (hazard r)."""
    cache = tmp_path / "models"
    (cache / "minilm-l6").mkdir(parents=True)
    _write_minilm(cache)
    ctx = _context(PORT, tmp_path, cache)
    if how == "config":
        ctx.config.embed_int8 = True
    else:
        monkeypatch.setenv("EIOKU_EMBED_INT8", "1")
    index = psem.SemanticIndex(ctx, batch_size=4, device="cpu")
    texts = _segment_texts()[:4]
    got = index.embed_texts(texts)
    assert isinstance(index._model.encoder.layer[0].attention.self.query, QuantLinear)
    params, cfg, pretrained = jml.load_minilm(str(cache))
    assert pretrained
    qparams = {k: jquant.quantize_linears(v) if k == "layers" else v
               for k, v in params.items()}
    ids, mask = index._tokenizer.encode_batch(texts)
    want = np.asarray(jml.minilm_embed(qparams, ids, mask, cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert (np.sum(got * want, axis=1) > 0.9999).all()


def test_index_without_a_device_raises_on_a_cpu_host(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = _context(PORT, tmp_path, tmp_path)
    index = psem.SemanticIndex(ctx)  # None is CUDA, resolved at first use
    with pytest.raises(RuntimeError, match="CUDA"):
        index.embed_texts(["hello"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Reranker(str(tmp_path)).available


# -- reranker ------------------------------------------------------------------------------


def _rerank_cache(cache) -> None:
    """A seeded full-width cross-encoder in HF layout ('bert.' trunk,
    'classifier'), and a vocab.txt in this cache of its own (hazard f)."""
    params = jce.init_cross_encoder_params(jce.CrossEncoderConfig(), seed=5)
    params["tok_emb"] = params["tok_emb"] * 100.0
    sd = {("" if k.startswith("classifier") else "bert.") + k: torch.tensor(v)
          for k, v in pce.from_jax_params(jax.tree.map(np.asarray, params)).items()}
    (cache / "msmarco-minilm-l6").mkdir(parents=True)
    torch.save(sd, cache / "msmarco-minilm-l6" / "pytorch_model.bin")
    words = sorted({w for t in TOPICS for w in t})
    (cache / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + words) + "\n")


@pytest.fixture(scope="module")
def rerank_cache(tmp_path_factory):
    cache = tmp_path_factory.mktemp("rerank_models")
    _rerank_cache(cache)
    return cache


def _results(n: int) -> list[dict]:
    texts = _segment_texts()
    return [{"text": texts[i % len(texts)] + f" {i}", "retrieval_rank": i}
            for i in range(n)]


@pytest.mark.parametrize("n,top_k", [(10, 10), (70, 70), (20, 5)])
def test_reranker_orders_as_jax(rerank_cache, n, top_k):
    query = "harbour boat anchor"
    results = _results(n)
    port, jaxr = Reranker(str(rerank_cache), device="cpu"), JaxReranker(str(rerank_cache))
    assert port.available and jaxr.available
    got = port.rerank(query, results, top_k)
    want = jaxr.rerank(query, results, top_k)
    assert len(got) == len(want) == min(top_k, n)
    scores = [w.get("rerank_score") for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        if "rerank_score" not in w:  # the tail past 64 keeps its order
            assert g == w and i >= 64
            continue
        assert abs(g["rerank_score"] - w["rerank_score"]) <= LOGIT_TOL
        neighbours = [scores[j] for j in (i - 1, i + 1) if 0 <= j < len(scores)
                      and scores[j] is not None]
        if all(abs(w["rerank_score"] - s) > LOGIT_TOL for s in neighbours):
            assert g["retrieval_rank"] == w["retrieval_rank"], i


def test_reranker_without_a_checkpoint_keeps_the_retrieval_order(tmp_path, rerank_cache):
    results = _results(12)
    bare = Reranker(str(tmp_path), device="cpu")
    assert not bare.available
    assert bare.rerank("harbour", results, 5) == results[:5]
    # a checkpoint without a vocab.txt is not enough either
    (tmp_path / "msmarco-minilm-l6").mkdir()
    (tmp_path / "msmarco-minilm-l6" / "pytorch_model.bin").write_bytes(
        (rerank_cache / "msmarco-minilm-l6" / "pytorch_model.bin").read_bytes())
    no_vocab = Reranker(str(tmp_path), device="cpu")
    assert not no_vocab.available
    assert no_vocab.rerank("harbour", results, 12) == results
