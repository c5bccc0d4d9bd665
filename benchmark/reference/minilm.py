"""all-MiniLM-L6-v2 as published (sentence-transformers: a BERT encoder,
mean pooling over the attention mask, L2 normalisation) in plain PyTorch,
with BERT's WordPiece tokenizer. Float32 unless a float8 `Arith` is given
(the control). Runs over a text's own tokens, with no padding (padding
under the mask changes nothing). Imports nothing of the program.
"""
from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Arith

LN_EPS = 1e-12
_SPLIT = re.compile(r"[a-z0-9]+|[!-/:-@\[-`{-~]")


class WordPiece:
    """BERT's uncased WordPiece on ASCII text: lower case, split on spaces
    and punctuation, greedy longest match with '##' continuations, [UNK]
    for a word that does not split; [CLS] ... [SEP], cut to max_len."""

    def __init__(self, vocab_lines: list[str], max_len: int = 256):
        self.ids = {w: i for i, w in enumerate(vocab_lines)}
        self.max_len = max_len

    def _word(self, word: str) -> list[int]:
        if len(word) > 100:
            return [self.ids["[UNK]"]]
        out, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.ids:
                    out.append(self.ids[piece])
                    start = end
                    break
            else:
                return [self.ids["[UNK]"]]
        return out

    def encode(self, text: str) -> list[int]:
        if not text.isascii():
            raise ValueError("the reference tokenizes ASCII text only")
        body: list[int] = []
        for word in _SPLIT.findall(text.lower()):
            body.extend(self._word(word))
        return [self.ids["[CLS]"]] + body[:self.max_len - 2] + [self.ids["[SEP]"]]


class MiniLM:
    """p: the HF BERT state dict (keys `embeddings.word_embeddings.weight`,
    `encoder.layer.N.attention.self.query.weight`, ...) in float32."""

    def __init__(self, p: dict[str, torch.Tensor], n_heads: int = 12, arith: Arith | None = None):
        self.p = p
        self.h = n_heads
        self.a = arith or Arith()
        self.layers = len({k.split(".")[2] for k in p if k.startswith("encoder.layer.")})

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"],
                            LN_EPS)

    def _lin(self, x, name):
        return self.a.linear(x, self.p[name + ".weight"], self.p[name + ".bias"])

    @torch.no_grad()
    def embed(self, ids: list[int]) -> torch.Tensor:
        """One text's token ids -> its L2-normalised embedding [d]."""
        p = self.p
        t = torch.tensor(ids, device=p["embeddings.word_embeddings.weight"].device)
        n = len(ids)
        x = (p["embeddings.word_embeddings.weight"][t]
             + p["embeddings.position_embeddings.weight"][:n]
             + p["embeddings.token_type_embeddings.weight"][0])
        x = self._ln(x, "embeddings.LayerNorm")[None]
        d = x.shape[-1]
        hd = d // self.h
        for i in range(self.layers):
            b = f"encoder.layer.{i}"
            q, k, v = (self._lin(x, f"{b}.attention.self.{n_}").view(1, n, self.h, hd)
                       .transpose(1, 2) for n_ in ("query", "key", "value"))
            s = self.a.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
            o = self.a.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(1, n, d)
            x = self._ln(x + self._lin(o, f"{b}.attention.output.dense"),
                         f"{b}.attention.output.LayerNorm")
            h = F.gelu(self._lin(x, f"{b}.intermediate.dense"))
            x = self._ln(x + self._lin(h, f"{b}.output.dense"), f"{b}.output.LayerNorm")
        pooled = x[0].mean(dim=0)
        return pooled / pooled.norm().clamp_min(1e-9)
