"""A deterministic stand-in for Moonlight's tokenizer (its tiktoken file is
not on the machine), as `models/clip/tokenizer.py`'s `FallbackClipTokenizer`
stands in for CLIP's: each whitespace-separated word is one id, its hash
over the ids below the specials. The top `SPECIALS` ids are reserved
(Moonlight's BOS 163,584 and EOS 163,585 are the first two of them), and
an id renders as a pseudo-word of three syllables, so generated ids read
back as text. It pairs with seeded or random weights only."""
from __future__ import annotations

import hashlib

SPECIALS = 256  # the top ids, reserved for special tokens
_ONSETS = "bdfghklmnprstvz"
_VOWELS = "aeiou"
_SYLLABLES = [c + v for c in _ONSETS for v in _VOWELS]  # 75: three of them cover 421,875 ids


class StandInTokenizer:
    def __init__(self, vocab_size: int, bos_id: int, eos_id: int):
        if vocab_size <= SPECIALS or not (vocab_size - SPECIALS <= min(bos_id, eos_id)
                                          and max(bos_id, eos_id) < vocab_size):
            raise ValueError(f"vocabulary {vocab_size}: the specials {bos_id}, {eos_id} must "
                             f"lie in its top {SPECIALS} ids")
        self.vocab_size = vocab_size
        self.words = vocab_size - SPECIALS  # ids 0 .. words - 1 are words
        self.bos_id, self.eos_id = bos_id, eos_id

    def encode(self, text: str) -> list[int]:
        return [int.from_bytes(hashlib.blake2b(w.encode(), digest_size=8).digest(), "little")
                % self.words for w in text.split()]

    def decode(self, ids: list[int]) -> str:
        """The word ids as pseudo-words; specials are left out."""
        n = len(_SYLLABLES)
        return " ".join(_SYLLABLES[i // (n * n)] + _SYLLABLES[i // n % n] + _SYLLABLES[i % n]
                        for i in ids if 0 <= i < self.words)
