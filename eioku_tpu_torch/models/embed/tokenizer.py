"""WordPiece tokenizer for the sentence-embedding model (a copy of
eioku_tpu/models/embed/tokenizer.py).

Implements BERT-style WordPiece (lowercase, punctuation split, greedy
longest-match subwords) loading a standard vocab.txt when available under the
model cache dir. In zero-egress environments with no vocab file, a
deterministic hashing fallback keeps the semantic pipeline runnable: words map
to stable pseudo-ids, which is consistent between indexing and querying (the
embedding weights are random in that regime anyway).
"""
from __future__ import annotations

import os
import unicodedata

import xxhash

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"
DEFAULT_VOCAB_SIZE = 30522


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


_ASCII_SPLIT = None


def basic_tokenize(text: str) -> list[str]:
    text = text.lower()
    if text.isascii():
        # fast path: regex split, no per-char unicodedata calls (the dominant
        # host cost of tokenization for English transcripts)
        global _ASCII_SPLIT
        if _ASCII_SPLIT is None:
            import re
            _ASCII_SPLIT = re.compile(
                r"[a-z0-9]+|[!-/:-@\[-`{-~]").findall
        return _ASCII_SPLIT(text)
    out: list[str] = []
    word = []
    for ch in unicodedata.normalize("NFD", text):
        if unicodedata.category(ch) == "Mn":
            continue
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punctuation(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int] | None = None,
                 vocab_size: int = DEFAULT_VOCAB_SIZE, max_len: int = 256):
        self.vocab = vocab
        self.vocab_size = len(vocab) if vocab else vocab_size
        self.max_len = max_len
        if vocab:
            self.pad_id = vocab.get(PAD, 0)
            self.unk_id = vocab.get(UNK, 100)
            self.cls_id = vocab.get(CLS, 101)
            self.sep_id = vocab.get(SEP, 102)
        else:
            self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 100, 101, 102
        self._native = None
        if vocab:
            try:
                from eioku_tpu_torch.models.embed.native_tokenizer import NativeWordPiece
                self._native = NativeWordPiece(vocab, self.unk_id)
            except Exception:
                self._native = None  # pure-Python fallback

    @classmethod
    def from_cache_dir(cls, cache_dir: str | None, max_len: int = 256
                       ) -> "WordPieceTokenizer":
        if cache_dir:
            for cand in ("vocab.txt", os.path.join("minilm-l6", "vocab.txt")):
                path = os.path.join(cache_dir, cand)
                if os.path.isfile(path):
                    with open(path, encoding="utf-8") as f:
                        vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
                    return cls(vocab=vocab, max_len=max_len)
        return cls(vocab=None, max_len=max_len)

    def _wordpiece(self, word: str) -> list[int]:
        if self.vocab is None:
            # hashing fallback: one stable id per word, skipping special ids
            h = xxhash.xxh64(word.encode()).intdigest() % (self.vocab_size - 1000)
            return [1000 + h]
        if len(word) > 100:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> tuple[list[int], list[int]]:
        """Returns (token_ids, attention_mask), fixed max_len with CLS/SEP."""
        words = basic_tokenize(text)
        if self._native is not None:
            body = self._native.encode_words(words, max_out=self.max_len)
            ids = [self.cls_id] + body[:self.max_len - 2]
        else:
            ids = [self.cls_id]
            for word in words:
                ids.extend(self._wordpiece(word))
                if len(ids) >= self.max_len - 1:
                    ids = ids[:self.max_len - 1]
                    break
        ids.append(self.sep_id)
        mask = [1] * len(ids)
        while len(ids) < self.max_len:
            ids.append(self.pad_id)
            mask.append(0)
        return ids, mask

    def _body_ids(self, text: str, cap: int) -> list[int]:
        """WordPiece ids of `text` (no specials), truncated to `cap`."""
        words = basic_tokenize(text)
        if self._native is not None:
            return self._native.encode_words(words, max_out=cap)[:cap]
        ids: list[int] = []
        for word in words:
            ids.extend(self._wordpiece(word))
            if len(ids) >= cap:
                return ids[:cap]
        return ids

    def encode_pair(self, query: str, passage: str, max_query: int = 64
                    ) -> tuple[list[int], list[int], list[int]]:
        """BERT pair encoding for the cross-encoder: `[CLS] query [SEP]
        passage [SEP]` -> (token_ids, type_ids, attention_mask), fixed
        max_len. The query is capped at max_query subwords so the passage
        keeps most of the window (rerank candidates are ~400-char chunks)."""
        q_ids = self._body_ids(query, min(max_query, self.max_len - 3))
        p_cap = self.max_len - 3 - len(q_ids)
        p_ids = self._body_ids(passage, max(p_cap, 0))
        ids = [self.cls_id] + q_ids + [self.sep_id] + p_ids + [self.sep_id]
        types = [0] * (len(q_ids) + 2) + [1] * (len(p_ids) + 1)
        mask = [1] * len(ids)
        while len(ids) < self.max_len:
            ids.append(self.pad_id)
            types.append(0)
            mask.append(0)
        return ids, types, mask

    def encode_pairs(self, query: str, passages: list[str]):
        import numpy as np
        n = len(passages)
        ids = np.zeros((n, self.max_len), np.int32)
        types = np.zeros((n, self.max_len), np.int32)
        mask = np.zeros((n, self.max_len), np.int32)
        for i, p in enumerate(passages):
            ids[i], types[i], mask[i] = self.encode_pair(query, p)
        return ids, types, mask

    def encode_batch(self, texts: list[str]):
        import numpy as np
        ids = np.zeros((len(texts), self.max_len), np.int32)
        mask = np.zeros((len(texts), self.max_len), np.int32)
        for i, t in enumerate(texts):
            a, b = self.encode(t)
            ids[i], mask[i] = a, b
        return ids, mask
