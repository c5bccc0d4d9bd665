"""ctypes bridge to the C++ WordPiece matcher (native/wordpiece.cpp); a copy
of eioku_tpu/models/embed/native_tokenizer.py.

The library is compiled with g++ on first use through the port's
utils/native_build.py into eioku_tpu_torch/_build/; loading falls back
cleanly to the pure-Python matcher when a compiler is unavailable. The Python
basic tokenizer (unicode normalization, punctuation splitting) stays in
Python: only the per-word greedy longest-match runs natively.
"""
from __future__ import annotations

import ctypes

from eioku_tpu_torch.utils.native_build import load_native_lib


def _configure(lib: ctypes.CDLL) -> None:
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode.restype = ctypes.c_int64
    lib.wp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]


def _load() -> ctypes.CDLL | None:
    return load_native_lib("wordpiece", _configure)


class NativeWordPiece:
    """Holds a native vocab handle; encode(words) -> list of subword ids."""

    def __init__(self, vocab: dict[str, int], unk_id: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native wordpiece unavailable")
        self._lib = lib
        self.unk_id = unk_id
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        # ids must be dense line indices; re-check and rebuild the blob
        blob = "\n".join(tok for tok, _ in ordered).encode("utf-8")
        if any(i != idx for idx, (_, i) in enumerate(ordered)):
            raise ValueError("vocab ids must be dense 0..N-1 for the native "
                             "matcher")
        self._handle = lib.wp_create(blob, len(blob), len(ordered))

    def encode_words(self, words: list[str], max_out: int = 4096) -> list[int]:
        blob = "\n".join(words).encode("utf-8")
        out = (ctypes.c_int32 * max_out)()
        n = self._lib.wp_encode(self._handle, blob, len(blob), self.unk_id,
                                out, max_out)
        return list(out[:n])

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.wp_destroy(self._handle)
        except Exception:
            pass
