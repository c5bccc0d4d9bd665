"""Visual retrieval index: CLIP keyframe embeddings + text-query search (port
of eioku_tpu/index/visual.py).

Scene keyframes run through CLIP's image tower into a flat vector file; a
text query is embedded by the text tower and moments are ranked by cosine.
Storage mirrors index/semantic.py: an append-only f16 vector file whose
slots map to rows of `frame_embeddings`; re-indexing a video replaces its
slots, and stale slots stop resolving. The index is derived state,
rebuildable by re-running visual_indexing.

Keyframes: the midpoint of every detected scene (latest run), else a fixed
stride; at most `max_keyframes` a video (uniform thinning). The combined
visual pass caches 1 s-grid keyframe JPEGs next to the index
(`keyframe_cache_dir`); indexing reads them and seek-decodes only the gaps.

Device: the model and the device corpus live on `device` (None = CUDA,
resolved at first use, so a host without a card can build the index and
fails only when it embeds or searches). CLIP runs fp32, the JAX config's
type. Scores are fp32 dot products of the f16 corpus and the query (no
TF32: PyTorch's default for fp32 matmuls on the card), ranked in
`lax.top_k`'s order (index/ivf.py `top_k`).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import uuid

import numpy as np
import torch

from eioku_tpu_torch.domain.artifacts import SelectionPolicy
from eioku_tpu_torch.index.ivf import top_k as _top_k
from eioku_tpu_torch.models.clip.model import (
    CLIP,
    ClipConfig,
    clip_encode_image,
    clip_encode_text,
    load_clip,
    preprocess_images,
)
from eioku_tpu_torch.models.clip.tokenizer import ClipTokenizer, FallbackClipTokenizer
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def _topk_cosine(corpus: torch.Tensor, q: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """corpus [N, D] f16, q [D] -> the top k (scores, slots) of the fp32
    dot products, highest first, ties to the lower slot."""
    return _top_k(corpus.float() @ q.float(), k)


class VisualIndex:
    MODEL_NAME = "clip-vit-b32"

    def __init__(self, ctx, data_dir: str | None = None, batch_size: int = 16,
                 device: torch.device | str | None = None):
        self.ctx = ctx
        base = data_dir or getattr(ctx.config, "index_dir", None)
        if base is None:
            if ctx.db.path not in (":memory:", ""):
                base = os.path.join(
                    os.path.dirname(os.path.abspath(ctx.db.path)),
                    "visual_index")
            else:
                import tempfile
                base = tempfile.mkdtemp(prefix="eioku_visual_")
        os.makedirs(base, exist_ok=True)
        self.data_dir = base
        self.vec_path = os.path.join(base, "vectors.f16")
        self.meta_path = os.path.join(base, "meta.json")
        self.batch_size = batch_size
        self.device = device
        self._dev: torch.device | None = None  # resolved at first use
        self._lock = threading.RLock()
        self._model: CLIP | None = None
        self._cfg: ClipConfig | None = None
        self._tokenizer = None
        self._corpus_device = None
        self._corpus_rows = -1
        self.pretrained = False

    # -- model ------------------------------------------------------------------

    def _device(self) -> torch.device:
        if self._dev is None:
            self._dev = resolve_device(self.device)  # None is CUDA: raises without a card
        return self._dev

    def _ensure_model(self) -> None:
        if self._model is not None:
            return
        cache = self.ctx.config.model_cache_dir
        self._model, self._cfg, self.pretrained = load_clip(cache, device=self._device())
        self._tokenizer = ClipTokenizer.from_cache_dir(cache) \
            or FallbackClipTokenizer(self._cfg.vocab_size)
        if not self.pretrained:
            log.warning("clip checkpoint not found; using random weights")

    @property
    def dim(self) -> int:
        if self._cfg is not None:
            return self._cfg.embed_dim
        # pure-vector paths (similar(), corpus loads) must not pay a full
        # dual-encoder load just to learn the row width: meta.json records it
        if os.path.isfile(self.meta_path):
            try:
                with open(self.meta_path) as f:
                    return int(json.load(f)["dim"])
            except (ValueError, KeyError, OSError):
                pass
        self._ensure_model()
        return self._cfg.embed_dim

    def embed_frames(self, frames: list[np.ndarray]) -> np.ndarray:
        """uint8 RGB frames (any geometry) -> L2-normalized [N, dim]; batches
        padded with zeros to `batch_size`."""
        self._ensure_model()
        out = np.zeros((len(frames), self.dim), np.float32)
        bs = self.batch_size
        pre = preprocess_images(frames, self._cfg)
        for i in range(0, len(pre), bs):
            batch = pre[i:i + bs]
            pad = bs - len(batch)
            if pad:
                batch = np.concatenate(
                    [batch, np.zeros((pad,) + batch.shape[1:], np.float32)])
            emb = clip_encode_image(self._model, torch.from_numpy(batch).to(self._dev))
            out[i:i + bs - pad] = emb[:bs - pad].cpu().numpy()
            progress.report((i + bs - pad) / len(pre))
        return out

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        self._ensure_model()
        ids = self._tokenizer.encode_batch(texts)
        return clip_encode_text(self._model, torch.from_numpy(np.asarray(ids)).to(
            self._dev)).cpu().numpy()

    # -- storage (same layout as the semantic index) ------------------------------

    def _vector_count(self) -> int:
        if not os.path.isfile(self.vec_path):
            return 0
        return os.path.getsize(self.vec_path) // (2 * self.dim)

    def _append_vectors(self, vecs: np.ndarray) -> int:
        with self._lock:
            start = self._vector_count()
            with open(self.vec_path, "ab") as f:
                f.write(vecs.astype(np.float16).tobytes())
            with open(self.meta_path, "w") as f:
                json.dump({"dim": self.dim, "model": self.MODEL_NAME,
                           "rows": start + len(vecs)}, f)
            self._corpus_rows = -1
            return start

    def _corpus(self) -> torch.Tensor | None:
        with self._lock:
            n = self._vector_count()
            if n == 0:
                return None
            if self._corpus_rows != n:
                raw = np.fromfile(self.vec_path, dtype=np.float16)
                self._corpus_device = torch.from_numpy(
                    raw[:n * self.dim].reshape(n, self.dim)).to(self._device())
                self._corpus_rows = n
            return self._corpus_device

    # -- indexing ---------------------------------------------------------------

    def _keyframe_stamps(self, video_id: str, duration_ms: int,
                         config: dict) -> list[tuple[int, int | None]]:
        """-> [(ts_ms, scene_index|None)]: scene midpoints, stride fallback."""
        max_frames = int(config.get("max_keyframes", 120))
        scenes = self.ctx.artifacts.get_by_asset(
            video_id, artifact_type="scene",
            selection=SelectionPolicy(mode="latest"))
        stamps: list[tuple[int, int | None]] = []
        if scenes:
            for e in sorted(scenes, key=lambda e: e.span_start_ms):
                mid = (e.span_start_ms + e.span_end_ms) // 2
                stamps.append((mid, e.payload_json.get("scene_index")))
        else:
            stride = int(float(config.get("keyframe_interval_s", 10.0)) * 1000)
            stamps = [(t, None) for t in range(stride // 2,
                                               max(duration_ms, 1), stride)]
            if not stamps:
                stamps = [(0, None)]
        if len(stamps) > max_frames:
            # uniform thinning keeps temporal coverage
            idx = np.linspace(0, len(stamps) - 1, max_frames).astype(int)
            stamps = [stamps[i] for i in idx]
        return stamps

    def keyframe_cache_dir(self, video_id: str) -> str:
        """Where the combined visual pass drops 1 s-grid keyframe JPEGs
        (ml/combined.py keyframe_cache_dir): index-adjacent, per video."""
        return os.path.join(self.data_dir, "keyframes", video_id)

    def _from_cache(self, video_id: str,
                    stamps: list[tuple[int, int | None]],
                    tolerance_ms: int = 1500) -> dict[int, np.ndarray]:
        """stamp position -> frame, for every stamp with a cached keyframe
        within tolerance: a cache hit spares this task a seek-decode of the
        source."""
        import cv2
        d = self.keyframe_cache_dir(video_id)
        try:
            avail = sorted(int(f[:-4]) for f in os.listdir(d)
                           if f.endswith(".jpg"))
        except OSError:
            return {}
        out: dict[int, np.ndarray] = {}
        for i, (ts, _) in enumerate(stamps):
            if not avail:
                break
            j = int(np.argmin([abs(a - ts) for a in avail]))
            if abs(avail[j] - ts) <= tolerance_ms:
                img = cv2.imread(os.path.join(d, f"{avail[j]}.jpg"))
                if img is not None:
                    out[i] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return out

    def _decode_at(self, path: str,
                   stamps: list[tuple[int, int | None]]) -> list[np.ndarray]:
        import cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise RuntimeError(f"cannot decode {path}")
        frames = []
        try:
            for ts, _ in stamps:  # ascending: each seek is a short forward hop
                cap.set(cv2.CAP_PROP_POS_MSEC, float(ts))
                ok, frame = cap.read()
                if not ok:
                    # past EOF (metadata duration can exceed the stream):
                    # reuse the last decodable frame
                    if frames:
                        frames.append(frames[-1])
                        continue
                    cap.set(cv2.CAP_PROP_POS_MSEC, 0.0)
                    ok, frame = cap.read()
                    if not ok:
                        raise RuntimeError(f"no decodable frames in {path}")
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
        return frames

    def index_video(self, video_id: str, config: dict | None = None) -> int:
        """Embed keyframes of a video into the index; returns frame count."""
        config = config or {}
        video = self.ctx.videos.get(video_id)
        if video is None or not os.path.isfile(video.path):
            raise RuntimeError(f"video {video_id} not found on disk")
        duration = video.duration_ms
        if not duration:
            from eioku_tpu_torch.ml import video_io
            duration = video_io.probe(video.path).duration_ms
        stamps = self._keyframe_stamps(video_id, duration, config)
        cached = self._from_cache(video_id, stamps)
        missing = [i for i in range(len(stamps)) if i not in cached]
        if missing:  # no/partial cache: seek-decode only the gaps
            decoded = self._decode_at(video.path,
                                      [stamps[i] for i in missing])
            cached.update(zip(missing, decoded))
        frames = [cached[i] for i in range(len(stamps))]
        vecs = self.embed_frames(frames)
        run_id = str(uuid.uuid4())
        # ONE BEGIN IMMEDIATE transaction around slot allocation + file append
        # + row insert: the sqlite write lock serializes concurrent indexers
        # ACROSS PROCESSES (multi-worker deployments), so two videos can never
        # claim the same slots / interleave their vector-file appends
        with self._lock, self.ctx.db.transaction() as conn:
            conn.execute(
                "DELETE FROM frame_embeddings WHERE asset_id=?", (video_id,))
            start = self._append_vectors(vecs)
            conn.executemany(
                "INSERT INTO frame_embeddings (slot, asset_id, ts_ms,"
                " scene_index, model, run_id) VALUES (?,?,?,?,?,?)",
                [(start + i, video_id, ts, scene_idx, self.MODEL_NAME,
                  run_id) for i, (ts, scene_idx) in enumerate(stamps)])
        log.info("visually indexed video", extra={
            "video_id": video_id, "keyframes": len(stamps)})
        return len(stamps)

    # -- query ------------------------------------------------------------------

    def search(self, query: str, top_k: int = 10,
               asset_id: str | None = None) -> list[dict]:
        corpus = self._corpus()
        if corpus is None:
            return []
        q = self.embed_texts([query])[0]
        k = min(top_k * 4, corpus.shape[0])
        while True:
            out = self._candidates(corpus, q, k, top_k, asset_id)
            if len(out) >= top_k or k >= corpus.shape[0]:
                return out[:top_k]
            k = min(k * 4, corpus.shape[0])

    def similar(self, asset_id: str, ts_ms: int, top_k: int = 10) -> list[dict]:
        """Visually similar moments across the library, anchored at the
        indexed keyframe nearest to (asset_id, ts_ms). Pure vector math:
        the anchor's embedding is already in the index, so no decode and no
        model call happen at query time."""
        row = self.ctx.db.query_one(
            "SELECT * FROM frame_embeddings WHERE asset_id=?"
            " ORDER BY ABS(ts_ms - ?) LIMIT 1", (asset_id, int(ts_ms)))
        if row is None:
            return []
        corpus = self._corpus()
        if corpus is None:
            return []
        anchor_slot = int(row["slot"])
        q = corpus[anchor_slot].float().cpu().numpy()
        k = min(top_k * 4 + 1, corpus.shape[0])
        while True:
            out = [r for r in self._candidates(corpus, q, k, top_k + 1, None)
                   if not (r["video_id"] == asset_id
                           and r["ts_ms"] == row["ts_ms"])]
            if len(out) >= top_k or k >= corpus.shape[0]:
                return out[:top_k]
            k = min(k * 4, corpus.shape[0])

    def _candidates(self, corpus: torch.Tensor, q: np.ndarray, k: int, top_k: int,
                    asset_id: str | None) -> list[dict]:
        scores, idx = _topk_cosine(corpus, torch.from_numpy(q).to(corpus.device), k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        out = []
        for score, slot in zip(scores, idx):
            row = self.ctx.db.query_one(
                "SELECT * FROM frame_embeddings WHERE slot=?", (int(slot),))
            if row is None:
                continue  # stale slot from a superseded run
            if asset_id and row["asset_id"] != asset_id:
                continue
            ts = row["ts_ms"]
            out.append({
                "score": float(score),
                "video_id": row["asset_id"],
                "text": "",  # no text payload: this is a visual moment
                "source": "visual",
                "ts_ms": ts,
                "scene_index": row["scene_index"],
                "jump_to": {"start_ms": max(ts - 1500, 0),
                            "end_ms": ts + 1500},
            })
            if len(out) >= top_k:
                break
        return out
