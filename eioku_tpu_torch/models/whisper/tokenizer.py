"""Whisper token vocabulary: special-token layout + GPT2-style byte-level BPE
decoding and encoding (the port's copy of eioku_tpu/models/whisper/tokenizer.py,
pure Python).

Transcription needs *decoding* (ids -> text); *encoding* (text -> ids,
WhisperTextEncoder) serves sot_prev prompt conditioning — custom vocabulary /
initial-prompt biasing, the reference engine's `initial_prompt`/`hotwords`
(faster-whisper WhisperModel.transcribe) and spec requirement 5.6
(.kiro/specs/semantic-video-search/requirements.md). When a standard
vocab.json (+ merges.txt for exact BPE) is present under the model cache dir
it is used; otherwise a deterministic placeholder decoding keeps the pipeline
functional (zero-egress environments run with random weights, so token ids
are arbitrary there anyway).

Special-token layout follows the public Whisper vocabularies:
  multilingual v2 (n_vocab 51865): eot 50257, sot 50258, 99 languages from
  50259, translate/transcribe follow, no_timestamps 50363
  large-v3 (n_vocab 51866): 100 languages, everything after shifted by one
"""
from __future__ import annotations

import json
import os
from functools import lru_cache

LANGUAGES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]


class WhisperTokens:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.eot = 50257
        self.sot = 50258
        self.lang_base = 50259
        self.n_langs = 100 if vocab_size >= 51866 else 99
        self.translate = self.lang_base + self.n_langs
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1  # <|0.00|>

    def lang_token(self, lang: str) -> int:
        try:
            return self.lang_base + LANGUAGES.index(lang)
        except ValueError:
            return self.lang_base  # default en

    def sot_sequence(self, lang: str | None = "en",
                     timestamps: bool = False,
                     task: str = "transcribe") -> list[int]:
        """task "translate" emits English regardless of source language
        (whisper's built-in X->en translation; faster-whisper's `task`
        parameter, serving config {"task": "translate"})."""
        task_tok = self.translate if task == "translate" else self.transcribe
        seq = [self.sot, self.lang_token(lang or "en"), task_tok]
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    def is_special(self, tok: int) -> bool:
        return tok >= self.eot

    def timestamp_seconds(self, tok: int) -> float | None:
        if tok >= self.timestamp_begin:
            return (tok - self.timestamp_begin) * 0.02
        return None


@lru_cache(maxsize=1)
def _byte_decoder() -> dict[str, int]:
    """GPT2 printable-char <-> byte mapping (inverse direction)."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def _byte_encoder() -> dict[int, str]:
    return {b: ch for ch, b in _byte_decoder().items()}


# GPT2 pre-tokenizer pattern (contractions, letter runs, number runs,
# punctuation runs, whitespace) — the same split OpenAI's tiktoken applies
_GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
               r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


class WhisperTextEncoder:
    """text -> ids for prompt conditioning.

    With merges.txt: exact byte-level BPE (tiktoken-equivalent). With only
    vocab.json: greedy longest-match over vocabulary pieces — every id is
    valid, segmentation is near-canonical, which is all prompt biasing needs.
    With neither: encode() returns [] and callers skip the prompt.
    """

    def __init__(self, vocab: dict[str, int] | None,
                 merges: list[tuple[str, str]] | None):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)} if merges else None
        self._max_piece = max((len(t) for t in vocab), default=0) if vocab else 0

    @classmethod
    def from_cache_dir(cls, cache_dir: str | None) -> "WhisperTextEncoder":
        vocab = merges = None
        if cache_dir:
            for cand in ("whisper/vocab.json", "vocab.json"):
                path = os.path.join(cache_dir, cand)
                if os.path.isfile(path):
                    with open(path, encoding="utf-8") as f:
                        vocab = json.load(f)
                    break
            for cand in ("whisper/merges.txt", "merges.txt"):
                path = os.path.join(cache_dir, cand)
                if os.path.isfile(path):
                    with open(path, encoding="utf-8") as f:
                        lines = f.read().splitlines()
                    # only the header line is a comment; later lines starting
                    # with '#' are real merges of '#' pieces (hashtag tokens)
                    if lines and lines[0].startswith("#version"):
                        lines = lines[1:]
                    merges = [tuple(ln.split(" ")) for ln in lines
                              if ln and len(ln.split(" ")) == 2]
                    break
        return cls(vocab, merges)

    def _bpe(self, piece: str) -> list[str]:
        parts = list(piece)
        while len(parts) > 1:
            pairs = [(self.ranks.get((a, b), 1 << 30), i)
                     for i, (a, b) in enumerate(zip(parts, parts[1:]))]
            rank, i = min(pairs)
            if rank == 1 << 30:
                break
            parts[i:i + 2] = [parts[i] + parts[i + 1]]
        return parts

    def encode(self, text: str) -> list[int]:
        if not self.vocab or not text:
            return []
        import regex  # GPT2 pattern needs \p{L}/\p{N}; dep of transformers

        be = _byte_encoder()
        ids: list[int] = []
        for piece in regex.findall(_GPT2_SPLIT, text):
            mapped = "".join(be[b] for b in piece.encode("utf-8"))
            if self.ranks is not None:
                for part in self._bpe(mapped):
                    tok = self.vocab.get(part)
                    if tok is not None:
                        ids.append(tok)
                continue
            # greedy longest-match fallback (no merges.txt)
            i = 0
            while i < len(mapped):
                for ln in range(min(self._max_piece, len(mapped) - i), 0, -1):
                    tok = self.vocab.get(mapped[i:i + ln])
                    if tok is not None:
                        ids.append(tok)
                        i += ln
                        break
                else:
                    i += 1  # unmappable byte char: skip
        return ids


class WhisperTextDecoder:
    """ids -> text. Uses vocab.json when available, placeholder otherwise."""

    def __init__(self, vocab: dict[str, int] | None, tokens: WhisperTokens):
        self.tokens = tokens
        self.id_to_token = {v: k for k, v in vocab.items()} if vocab else None

    @classmethod
    def from_cache_dir(cls, cache_dir: str | None, vocab_size: int
                       ) -> "WhisperTextDecoder":
        tokens = WhisperTokens(vocab_size)
        if cache_dir:
            for cand in ("whisper/vocab.json", "vocab.json"):
                path = os.path.join(cache_dir, cand)
                if os.path.isfile(path):
                    with open(path, encoding="utf-8") as f:
                        return cls(json.load(f), tokens)
        return cls(None, tokens)

    def decode(self, ids: list[int]) -> str:
        text_ids = [i for i in ids if not self.tokens.is_special(i)]
        if not text_ids:
            return ""
        if self.id_to_token is None:
            # placeholder decoding: stable, clearly non-linguistic
            return " ".join(f"<{i}>" for i in text_ids)
        bd = _byte_decoder()
        raw = "".join(self.id_to_token.get(i, "") for i in text_ids)
        data = bytes(bd.get(ch, ord(" ") if ord(ch) < 256 else 32) for ch in raw)
        return data.decode("utf-8", errors="replace").strip()
