"""CLIP byte-level BPE tokenizer (vocab.json + merges.txt), first-party.

Copy of eioku_tpu/models/clip/tokenizer.py for the PyTorch port (pure
Python, no JAX).

Matches HuggingFace `CLIPTokenizer` (tokenization_clip.py): whitespace
cleanup + lowercase, regex pre-tokenization, GPT-2 bytes->unicode mapping,
BPE with the `</w>` end-of-word convention, `<|startoftext|>` /
`<|endoftext|>` specials, context length 77 with zero padding (the original
OpenAI convention; the text tower pools at argmax(ids) = first EOT, so the
padding value never matters).

Zero-egress fallback: without vocab files a deterministic hash tokenizer
keeps the pipeline functional (embeddings are noise with random weights
anyway, exactly like the other model families' fallbacks).
"""
from __future__ import annotations

import json
import os
import re
from functools import lru_cache


@lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte->printable-unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("\xa1"), ord("\xac") + 1)) + \
        list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# translation of HF's \p{L}+ | \p{N} | [^\s\p{L}\p{N}]+ into stdlib `re`:
# [^\W\d_] == \p{L}; underscore is neither letter nor number, so it belongs
# to the punctuation-run branch ((?:[^\s\w]|_)+)
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 context_length: int = 77):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.context_length = context_length
        self.sot_id = vocab[self.SOT]
        self.eot_id = vocab[self.EOT]
        self.byte_encoder = _bytes_to_unicode()
        self._bpe_cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str,
                   context_length: int = 77) -> "ClipTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, context_length)

    @classmethod
    def from_cache_dir(cls, cache_dir: str | None,
                       context_length: int = 77) -> "ClipTokenizer | None":
        if not cache_dir:
            return None
        base = os.path.join(cache_dir, "clip-vit-b32")
        v, m = os.path.join(base, "vocab.json"), os.path.join(base, "merges.txt")
        if os.path.isfile(v) and os.path.isfile(m):
            return cls.from_files(v, m, context_length)
        return None

    def _bpe(self, token: str) -> list[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._bpe_cache[token] = out
        return out

    def tokenize(self, text: str) -> list[int]:
        text = _whitespace_clean(text).lower()
        ids: list[int] = []
        for tok in _PAT.findall(text):
            if tok in (self.SOT, self.EOT):  # literal specials stay atomic
                ids.append(self.vocab[tok])
                continue
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab.get(piece, self.eot_id))
        return ids

    def encode_batch(self, texts: list[str]):
        """-> int32 [B, context_length]: SOT ids... EOT, zero-padded."""
        import numpy as np
        out = np.zeros((len(texts), self.context_length), np.int32)
        budget = self.context_length - 2
        for i, text in enumerate(texts):
            ids = self.tokenize(text)[:budget]
            row = [self.sot_id] + ids + [self.eot_id]
            out[i, :len(row)] = row
        return out


class FallbackClipTokenizer:
    """Deterministic word-hash tokenizer for zero-egress runs (no vocab
    files). Same encode_batch contract; pairs with random-init weights."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot_id = vocab_size - 2
        self.eot_id = vocab_size - 1

    def encode_batch(self, texts: list[str]):
        import numpy as np
        import xxhash
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            words = _whitespace_clean(text).lower().split()
            ids = [xxhash.xxh64_intdigest(w) % (self.vocab_size - 2)
                   for w in words][:self.context_length - 2]
            row = [self.sot_id] + ids + [self.eot_id]
            out[i, :len(row)] = row
        return out
