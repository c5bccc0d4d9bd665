"""Cross-encoder reranking stage for search (port of
eioku_tpu/index/rerank.py).

Retrieval over-fetches candidates; this stage jointly scores each (query,
candidate-text) pair with the ms-marco cross-encoder
(models/embed/cross_encoder.py) and reorders by that score. It is gated on
a real checkpoint and a vocab.txt: a random-init cross-encoder would
shuffle results, so without `msmarco-minilm-l6/pytorch_model.bin` under the
model cache the stage reports unavailable and the retrieval order stands.

Candidates pad to fixed batch buckets (8, 16, 32, 64); the trunk runs bf16
on the card and fp32 on the CPU (utils/device.compute_dtype). The device is
resolved when the model is first needed: None is CUDA, which raises on a
host without a card rather than degrading.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import replace

import numpy as np
import torch

from eioku_tpu_torch.utils.device import compute_dtype_name, resolve_device

log = logging.getLogger(__name__)

_BUCKETS = (8, 16, 32, 64)
MAX_CANDIDATES = _BUCKETS[-1]


class Reranker:
    def __init__(self, model_cache_dir: str | None = None, max_len: int = 256,
                 device: torch.device | str | None = None):
        self.model_cache_dir = model_cache_dir
        self.max_len = max_len
        self.device = device
        self._lock = threading.Lock()
        self._loaded = False
        self._model = None  # (model, tokenizer, device) when available

    def _ensure_model(self) -> bool:
        with self._lock:
            if self._loaded:
                return self._model is not None
            dev = resolve_device(self.device)  # outside the guard: no fallback
            self._loaded = True
            self._model = None
            try:
                from eioku_tpu_torch.models.embed.cross_encoder import (
                    load_cross_encoder,
                )
                from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer

                model, cfg, pretrained = load_cross_encoder(self.model_cache_dir,
                                                            device=dev)
                tok = WordPieceTokenizer.from_cache_dir(self.model_cache_dir,
                                                        max_len=self.max_len)
            except Exception:
                # a corrupt/truncated/wrong-shape checkpoint must degrade to
                # retrieval order (the module contract), never fail a search
                log.exception("cross-encoder checkpoint failed to load; "
                              "rerank disabled")
                return False
            if not pretrained or tok.vocab is None:
                log.info("cross-encoder rerank unavailable (checkpoint=%s "
                         "vocab=%s); retrieval order stands",
                         pretrained, tok.vocab is not None)
                return False
            model.cfg = replace(cfg, compute_dtype=compute_dtype_name(dev))
            self._model = (model, tok, dev)
            log.info("loaded cross-encoder reranker")
            return True

    @property
    def available(self) -> bool:
        return self._ensure_model()

    def rerank(self, query: str, results: list[dict],
               top_k: int) -> list[dict]:
        """Reorder `results` (dicts with a "text" field) by joint
        query-passage relevance; each rescored result gains "rerank_score".
        Only the first MAX_CANDIDATES are rescored; anything beyond keeps
        its retrieval position after them, so top_k > MAX_CANDIDATES never
        loses results."""
        if not results or not self._ensure_model():
            return results[:top_k]
        from eioku_tpu_torch.models.embed.cross_encoder import cross_encoder_score

        model, tok, dev = self._model
        cands, tail = results[:MAX_CANDIDATES], results[MAX_CANDIDATES:]
        ids, types, mask = tok.encode_pairs(query,
                                            [r.get("text") or "" for r in cands])
        bucket = next(b for b in _BUCKETS if b >= len(cands))
        pad = bucket - len(cands)
        if pad:  # fixed batch buckets
            z = np.zeros((pad, ids.shape[1]), np.int32)
            ids, types, mask = (np.concatenate([a, z]) for a in (ids, types, mask))
        scores = cross_encoder_score(
            model, *(torch.from_numpy(a).to(dev) for a in (ids, types, mask))
        ).cpu().numpy()[:len(cands)]
        order = np.argsort(-scores)
        ranked = [{**cands[i], "rerank_score": float(scores[i])} for i in order]
        return (ranked + tail)[:top_k]
