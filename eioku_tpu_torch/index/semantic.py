"""Semantic retrieval index: transcript chunks -> MiniLM vectors -> cosine
top-k on the device (port of eioku_tpu/index/semantic.py).

- chunking: transcript segments merged into ~chunk_chars character windows
  with overlap, each spanning [first segment start, last segment end];
- vectors: float16 rows appended to a flat file (dim from meta.json); row
  index == `slot` in the embedding_chunks projection table;
- search: the query embedded on the device, scores = corpus @ q with bf16
  inputs and fp32 accumulation, top-k with ties to the lower index; the
  corpus is a cached device tensor, re-uploaded only after appends; from
  IVF_THRESHOLD vectors up the IVF index (ivf.py) takes over;
- artifacts: each chunk is also an embedding.chunk ArtifactEnvelope, so
  runs, selection and provenance work as for every other artifact type.

Device and precision: the index runs on `device` (None = CUDA, resolved
when the model is first needed, so a host without a card can build the
index and fails only when it embeds). On the card MiniLM runs bf16
activations, the JAX indexing path's type; on the CPU it runs fp32, the
port's rule for CPU parity (utils/device.compute_dtype). The int8 embedder
(`embed_int8`, or EIOKU_EMBED_INT8=1) quantizes MiniLM's encoder layers
(ops/quant.py), as the JAX package quantizes its `layers`; the embeddings
and their layer norm stay float. The artifacts' producer is
`eioku-tpu-torch-semantic`.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import uuid
from dataclasses import replace

import numpy as np
import torch

from eioku_tpu_torch.domain.artifacts import SelectionPolicy, utcnow
from eioku_tpu_torch.index.ivf import top_k as _top_k
from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, load_minilm, minilm_embed
from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer
from eioku_tpu_torch.models.layers import quantize_linears
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import compute_dtype_name, resolve_device
from eioku_tpu_torch.utils.hashing import compute_config_hash
from eioku_tpu_torch.workers.task_handler import build_envelopes

log = logging.getLogger(__name__)

PRODUCER = "eioku-tpu-torch-semantic"

_STOPWORDS = frozenset(
    "the a an and or but if then else for while of to in on at by with from as "
    "is are was were be been being has have had do does did will would can "
    "could should may might must this that these those it its they them their "
    "he she his her you your we our i me my not no yes so than too very just "
    "about into over under again there here when where why how all any both "
    "each few more most other some such only own same s t don now what which "
    "who whom because until against between through during before after above "
    "below up down out off further once also like get got one two".split())


def _topk_cosine(corpus: torch.Tensor, query: torch.Tensor,
                 top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """corpus [N, D] (L2-normalised, f16/bf16), query [D] -> (scores, idx)
    top-k. Both are rounded to bf16 and the dot products accumulate in fp32
    (bf16 values are exact in fp32 and in TF32), as the JAX package's
    `_topk_cosine` computes them."""
    scores = corpus.to(torch.bfloat16).float() @ query.to(torch.bfloat16).float()
    return _top_k(scores, top_k)


def chunk_segments(segments: list[dict], chunk_chars: int = 400,
                   overlap_chars: int = 80) -> list[dict]:
    """Merge ordered transcript segments into overlapping text chunks.

    Each segment dict needs text/start_ms/end_ms. Returns chunk dicts with
    text/start_ms/end_ms. Overlap is implemented by re-including trailing
    segments whose combined text is <= overlap_chars.
    """
    chunks: list[dict] = []
    cur: list[dict] = []
    cur_len = 0
    for seg in segments:
        text = (seg.get("text") or "").strip()
        if not text:
            continue
        cur.append({"text": text, "start_ms": seg["start_ms"],
                    "end_ms": seg["end_ms"]})
        cur_len += len(text) + 1
        if cur_len >= chunk_chars:
            chunks.append(_merge(cur))
            # keep a tail for overlap
            tail: list[dict] = []
            tail_len = 0
            for s in reversed(cur):
                if tail_len + len(s["text"]) > overlap_chars:
                    break
                tail.insert(0, s)
                tail_len += len(s["text"]) + 1
            cur, cur_len = tail, tail_len
    if cur and (not chunks or _merge(cur)["text"] != chunks[-1]["text"]):
        chunks.append(_merge(cur))
    return chunks


def _merge(segs: list[dict]) -> dict:
    return {"text": " ".join(s["text"] for s in segs),
            "start_ms": segs[0]["start_ms"], "end_ms": segs[-1]["end_ms"]}


class SemanticIndex:
    MODEL_NAME = "minilm-l6"

    def __init__(self, ctx, data_dir: str | None = None, batch_size: int = 32,
                 device: torch.device | str | None = None):
        self.ctx = ctx
        base = data_dir or getattr(ctx.config, "index_dir", None)
        if base is None:
            if ctx.db.path not in (":memory:", ""):
                base = os.path.join(os.path.dirname(os.path.abspath(ctx.db.path)),
                                    "semantic_index")
            else:
                import tempfile
                base = tempfile.mkdtemp(prefix="eioku_index_")
        os.makedirs(base, exist_ok=True)
        self.data_dir = base
        self.vec_path = os.path.join(base, "vectors.f16")
        self.meta_path = os.path.join(base, "meta.json")
        self.batch_size = batch_size
        self.device = device
        self._dev: torch.device | None = None  # resolved with the model
        self._lock = threading.RLock()
        self._model = None
        self._cfg: MiniLMConfig | None = None
        self._tokenizer: WordPieceTokenizer | None = None
        self._corpus_device = None  # cached device tensor
        self._corpus_rows = -1
        self._ivf_cache = None
        self.pretrained = False

    # -- model -----------------------------------------------------------------

    def _ensure_model(self):
        if self._model is None:
            dev = resolve_device(self.device)  # None is CUDA: raises without a card
            cache = self.ctx.config.model_cache_dir
            model, cfg, self.pretrained = load_minilm(cache, device=dev)
            # the indexing path's activations: bf16 on the card, fp32 on the CPU
            model.cfg = self._cfg = replace(cfg, compute_dtype=compute_dtype_name(dev))
            if (getattr(self.ctx.config, "embed_int8", False)
                    or os.environ.get("EIOKU_EMBED_INT8") == "1"):
                quantize_linears(model.encoder)
                log.info("int8-quantized embedder enabled")
            self._dev = dev
            self._tokenizer = WordPieceTokenizer.from_cache_dir(cache, max_len=256)
            self._model = model
            if not self.pretrained:
                log.warning("minilm checkpoint not found; using random weights")

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        self._ensure_model()
        out = np.zeros((len(texts), self._cfg.dim), np.float32)
        bs = self.batch_size
        for i in range(0, len(texts), bs):
            batch = texts[i:i + bs]
            pad = bs - len(batch)
            ids, mask = self._tokenizer.encode_batch(batch + [""] * pad)
            emb = minilm_embed(self._model, torch.from_numpy(ids).to(self._dev),
                               torch.from_numpy(mask).to(self._dev))
            out[i:i + len(batch)] = emb[:len(batch)].cpu().numpy()
            progress.report((i + len(batch)) / len(texts))
        return out

    # -- storage ------------------------------------------------------------------

    @property
    def dim(self) -> int:
        self._ensure_model()
        return self._cfg.dim

    def _vector_count(self) -> int:
        if not os.path.isfile(self.vec_path):
            return 0
        return os.path.getsize(self.vec_path) // (2 * self.dim)

    def _append_vectors(self, vecs: np.ndarray) -> int:
        """Append rows, returns starting slot."""
        with self._lock:
            start = self._vector_count()
            with open(self.vec_path, "ab") as f:
                f.write(vecs.astype(np.float16).tobytes())
            with open(self.meta_path, "w") as f:
                json.dump({"dim": self.dim, "model": self.MODEL_NAME,
                           "rows": start + len(vecs)}, f)
            self._corpus_rows = -1  # invalidate device cache
            return start

    def _corpus(self) -> torch.Tensor | None:
        with self._lock:
            n = self._vector_count()
            if n == 0:
                return None
            if self._corpus_rows != n:
                raw = np.fromfile(self.vec_path, dtype=np.float16)
                # a crash mid-append can leave a partial trailing row; the
                # slice keeps the index usable instead of failing reshape
                self._corpus_device = torch.from_numpy(
                    raw[:n * self.dim].reshape(n, self.dim)).to(self._dev)
                self._corpus_rows = n
            return self._corpus_device

    # -- indexing ---------------------------------------------------------------------

    def index_video(self, video_id: str, config: dict | None = None) -> int:
        """Embed the latest transcript run (and on-screen OCR text) of a video
        into the index. Returns number of chunks indexed."""
        config = config or {}
        segments = self.ctx.artifacts.get_by_asset(
            video_id, artifact_type="transcript.segment",
            selection=SelectionPolicy(mode="latest"))
        segs = [{"text": e.payload_json.get("text", ""),
                 "start_ms": e.span_start_ms, "end_ms": e.span_end_ms}
                for e in segments]
        chunks = chunk_segments(
            segs, chunk_chars=int(config.get("chunk_chars", 400)),
            overlap_chars=int(config.get("overlap_chars", 80)))
        chunks = [dict(c, source="transcript") for c in chunks]
        if config.get("index_ocr", True):
            ocr = self.ctx.artifacts.get_by_asset(
                video_id, artifact_type="ocr.text",
                selection=SelectionPolicy(mode="latest"))
            ocr_segs = [{"text": e.payload_json.get("text", ""),
                         "start_ms": e.span_start_ms, "end_ms": e.span_end_ms}
                        for e in ocr]
            ocr_chunks = chunk_segments(
                ocr_segs, chunk_chars=int(config.get("chunk_chars", 400)),
                overlap_chars=0)
            chunks.extend(dict(c, source="ocr") for c in ocr_chunks)
        if not chunks:
            return 0
        vecs = self.embed_texts([c["text"] for c in chunks])
        run_id = str(uuid.uuid4())
        # ONE BEGIN IMMEDIATE transaction around slot allocation + file append
        # + artifact insert: the sqlite write lock serializes concurrent
        # indexers ACROSS PROCESSES, so slot numbers and vector-file appends
        # can never interleave between two workers
        with self._lock, self.ctx.db.transaction():
            # drop stale slots for this asset (old runs stay in file, unmapped)
            self.ctx.db.execute(
                "DELETE FROM embedding_chunks WHERE asset_id=?", (video_id,))
            start_slot = self._append_vectors(vecs)
            results = [
                {"payload": {"text": c["text"], "source": c["source"],
                             "model": self.MODEL_NAME, "dim": self.dim,
                             "index_slot": start_slot + i,
                             "norm": float(np.linalg.norm(vecs[i]))},
                 "span_start_ms": c["start_ms"], "span_end_ms": c["end_ms"]}
                for i, c in enumerate(chunks)
            ]
            envs = build_envelopes(
                results, video_id=video_id, artifact_type="embedding.chunk",
                run_id=run_id, producer=PRODUCER,
                producer_version="0.1.0",
                model_profile=self.ctx.config.model_profile,
                config_hash=compute_config_hash(config),
                input_hash="transcript")
            self.ctx.artifacts.batch_create(envs)
        self._extract_topics(video_id, [c["text"] for c in chunks],
                             top_k=int(config.get("topics_top_k", 10)))
        log.info("indexed video", extra={"video_id": video_id,
                                         "chunks": len(chunks)})
        return len(chunks)

    def _extract_topics(self, video_id: str, texts: list[str],
                        top_k: int = 10) -> None:
        """TF-IDF-style topic terms into the topics table."""
        import math
        import re

        tf: dict[str, int] = {}
        df: dict[str, int] = {}
        for text in texts:
            words = set()
            for w in re.findall(r"[a-zA-Z][a-zA-Z'-]{2,}", text.lower()):
                if w in _STOPWORDS:
                    continue
                tf[w] = tf.get(w, 0) + 1
                words.add(w)
            for w in words:
                df[w] = df.get(w, 0) + 1
        n_docs = max(len(texts), 1)
        scored = sorted(
            ((w, tf[w] * math.log(1.0 + n_docs / df[w])) for w in tf),
            key=lambda kv: kv[1], reverse=True)[:top_k]
        if not scored:
            return
        top = scored[0][1] or 1.0
        with self.ctx.db.transaction() as conn:
            conn.execute("DELETE FROM topics WHERE asset_id=?", (video_id,))
            conn.executemany(
                "INSERT INTO topics (id, asset_id, label, score, created_at)"
                " VALUES (?,?,?,?,?)",
                [(str(uuid.uuid4()), video_id, w, round(s / top, 4),
                  utcnow().isoformat()) for w, s in scored])

    def rebuild(self) -> int:
        """Re-embed every video that has indexable text (the flat file is
        derived state and fully rebuildable). Also compacts slots freed by
        superseded runs."""
        asset_rows = self.ctx.db.query(
            "SELECT DISTINCT asset_id FROM artifacts"
            " WHERE artifact_type IN ('transcript.segment', 'ocr.text')")
        with self._lock:
            for path in (self.vec_path, self.meta_path):
                if os.path.isfile(path):
                    os.remove(path)
            self._corpus_rows = -1
            self._ivf_cache = None
        self.ctx.db.execute("DELETE FROM embedding_chunks")
        total = 0
        for r in asset_rows:
            total += self.index_video(r["asset_id"], {})
        return total

    # -- search ---------------------------------------------------------------------------

    IVF_THRESHOLD = 4096  # brute force is faster below this corpus size

    def _ivf(self, corpus: torch.Tensor):
        n = corpus.shape[0]
        if n < self.IVF_THRESHOLD:
            return None
        cached = self._ivf_cache
        if cached is not None and cached.n_vectors == n:
            return cached
        from eioku_tpu_torch.index.ivf import IvfIndex

        self._ivf_cache = IvfIndex.build(corpus)
        log.info("built IVF index", extra={"vectors": n,
                                           "clusters": self._ivf_cache.k})
        return self._ivf_cache

    def search(self, query: str, top_k: int = 10,
               asset_id: str | None = None) -> list[dict]:
        corpus = self._corpus()
        if corpus is None:
            return []
        q = self.embed_texts([query])[0]
        # over-fetch: the vector file retains slots from superseded runs (and
        # other assets when filtering), which are dropped during the row
        # join below; escalate k until top_k live hits or corpus exhausted
        k = min(top_k * 4, corpus.shape[0])
        while True:
            out = self._candidates(corpus, q, k, top_k, asset_id)
            if len(out) >= top_k or k >= corpus.shape[0]:
                return out[:top_k]
            k = min(k * 4, corpus.shape[0])

    def _candidates(self, corpus: torch.Tensor, q: np.ndarray, k: int, top_k: int,
                    asset_id: str | None) -> list[dict]:
        ivf = self._ivf(corpus)
        if ivf is not None:
            scores, idx = ivf.search(q, top_k=k)
            keep = idx >= 0
            scores, idx = scores[keep], idx[keep]
        else:
            scores, idx = _topk_cosine(corpus, torch.from_numpy(q).to(corpus.device), k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        out = []
        for score, slot in zip(scores, idx):
            row = self.ctx.db.query_one(
                "SELECT * FROM embedding_chunks WHERE slot=?", (int(slot),))
            if row is None:
                continue  # stale slot from a superseded run
            if asset_id and row["asset_id"] != asset_id:
                continue
            out.append({
                "score": float(score),
                "video_id": row["asset_id"],
                "text": row["text"],
                "source": row["source"],
                "artifact_id": row["artifact_id"],
                "jump_to": {"start_ms": row["start_ms"], "end_ms": row["end_ms"]},
            })
            if len(out) >= top_k:
                break
        return out
