"""Word-level timestamps from cross-attention alignment, host side (copy of
eioku_tpu/models/whisper/align.py, apart from the import prefix).

`model.cross_attention_alignment` runs one teacher-forced decoder pass per
batch on the device and hands over a z-normalised, head-averaged
[S_text, 1500] matrix per window; this module does the sequential parts on
the host: a median filter, monotonic DTW (native/dtw.cpp, built into the
port's own `_build/`, with the Python recurrence as its fallback) and the
grouping of byte-BPE tokens into words.

Each audio frame is 20 ms (Whisper's mel hop 10 ms x conv stride 2).
"""
from __future__ import annotations

import ctypes

import numpy as np

from eioku_tpu_torch.utils.native_build import load_native_lib

FRAME_MS = 20


def _configure_dtw(lib: ctypes.CDLL) -> None:
    lib.dtw_best_path.restype = ctypes.c_int64
    lib.dtw_best_path.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64]


def _load_native() -> ctypes.CDLL | None:
    return load_native_lib("dtw", _configure_dtw)


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last (audio) axis, edge-padded."""
    if width <= 1 or x.shape[-1] == 0:
        return x
    half = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through cost [N_text, N_frames].

    Returns (text_indices, frame_indices) of the optimal path. Standard
    three-move recurrence (match, skip-frame, skip-text) with backtrace.
    Runs in native C++ (native/dtw.cpp) when the toolchain is available; the
    pure-Python recurrence below is the fallback and the reference
    implementation for tests.
    """
    n, m = cost.shape
    lib = _load_native()
    if lib is not None and n > 0 and m > 0:
        c = np.ascontiguousarray(cost, np.float32)
        max_out = n + m
        ti = (ctypes.c_int32 * max_out)()
        fi = (ctypes.c_int32 * max_out)()
        ln = lib.dtw_best_path(
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, m, ti, fi,
            max_out)
        if ln >= 0:
            return (np.frombuffer(ti, np.int32, ln).copy(),
                    np.frombuffer(fi, np.int32, ln).copy())
    acc = np.full((n + 1, m + 1), np.inf, np.float64)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), np.uint8)
    for i in range(1, n + 1):
        row_c = cost[i - 1]
        prev = acc[i - 1]
        cur = acc[i]
        for j in range(1, m + 1):
            c0, c1, c2 = prev[j - 1], prev[j], cur[j - 1]
            if c0 <= c1 and c0 <= c2:
                cur[j] = c0 + row_c[j - 1]
                trace[i, j] = 0  # diagonal
            elif c1 <= c2:
                cur[j] = c1 + row_c[j - 1]
                trace[i, j] = 1  # advance text
            else:
                cur[j] = c2 + row_c[j - 1]
                trace[i, j] = 2  # advance frame
    ti, fi = [], []
    i, j = n, m
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(fi[::-1])


def group_tokens_into_words(tokens: list[int], text_decoder
                            ) -> list[tuple[str, list[int]]]:
    """Group byte-BPE token ids into words by leading whitespace.

    Returns [(word, [positions of its tokens in `tokens`])]. Requires a real
    vocabulary (text_decoder.id_to_token); placeholder decoding has no word
    structure, so the caller should skip word timing without one.
    """
    words: list[tuple[str, list[int]]] = []
    cur_ids: list[int] = []
    cur_pos: list[int] = []

    def flush():
        if cur_pos:
            word = text_decoder.decode(cur_ids)
            if word:
                words.append((word, list(cur_pos)))
        cur_ids.clear()
        cur_pos.clear()

    for pos, tok in enumerate(tokens):
        if text_decoder.tokens.is_special(tok):
            continue
        piece = text_decoder.id_to_token.get(tok, "")
        # GPT2 byte-BPE: a leading "Ġ" (the space byte's printable form,
        # U+0120) starts a new word
        if piece.startswith("Ġ") and cur_pos:
            flush()
        cur_ids.append(tok)
        cur_pos.append(pos)
    flush()
    return words


def word_timestamps(align_matrix: np.ndarray, tokens: list[int], text_decoder,
                    window_start_ms: int, n_audio_frames: int,
                    medfilt_width: int = 7) -> list[dict]:
    """Turn one window's alignment energy into per-word timings.

    align_matrix [S, 1500] (higher = stronger text->frame attention) covers
    the padded 30 s window; only the first `n_audio_frames` frames carry real
    audio. Returns WordTiming-shaped dicts with absolute milliseconds.
    """
    if align_matrix.shape[0] == 0 or not tokens:
        return []
    if getattr(text_decoder, "id_to_token", None) is None:
        return []
    m = median_filter(align_matrix.astype(np.float64), medfilt_width)
    m = m[:, :max(n_audio_frames, 1)]
    ti, fi = dtw_path(-m)
    # first aligned frame per token position (path is monotone in both axes)
    first_frame = {}
    last_frame = {}
    for t, f in zip(ti, fi):
        first_frame.setdefault(int(t), int(f))
        last_frame[int(t)] = int(f)
    out: list[dict] = []
    for word, positions in group_tokens_into_words(tokens, text_decoder):
        starts = [first_frame[p] for p in positions if p in first_frame]
        ends = [last_frame[p] for p in positions if p in last_frame]
        if not starts or not ends:
            continue
        s_ms = window_start_ms + min(starts) * FRAME_MS
        e_ms = window_start_ms + (max(ends) + 1) * FRAME_MS
        out.append({"word": word, "start_ms": int(s_ms),
                    "end_ms": int(max(e_ms, s_ms))})
    return out
