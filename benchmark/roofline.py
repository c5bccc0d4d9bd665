"""The table of peaks and the operation counts that the roofline and MFU
metrics divide by. Counts are multiply-adds times two, from shapes alone;
they count the work the inputs need (real windows, real beam rows, real
tokens), not padding, except where a kernel is handed the padding itself.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, without sparsity, at the full 700 W (NVIDIA's data
# sheet); a card set to a lower power limit runs below these
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
              "int8": 1979e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def flash_attention_flops(b: int, h: int, s: int, d: int) -> float:
    """K3 (non-causal, no padding): Q K^T and P V, 2 S^2 D multiply-adds a
    head."""
    return 4.0 * b * h * s * s * d


def flash_attention_bound_s(b: int, h: int, s: int, d: int) -> float:
    """The least time for one bf16 K3 call: the larger of its operations at
    the peak and its bytes (Q, K, V read once, O written once) at the
    bandwidth."""
    return max(flash_attention_flops(b, h, s, d) / PEAK_FLOPS["bfloat16"],
               4 * b * h * s * d * 2 / PEAK_BYTES_PER_S)


# -- Whisper ---------------------------------------------------------------------------


def whisper_encoder_flops(windows: int, d: int, layers: int, n_mels: int,
                          frames: int = 3000) -> float:
    """The encoder on `windows` 30 s windows: the two convs (k = 3, the second
    of stride 2), and per layer the four projections, attention and the MLP
    (4 d)."""
    s = frames // 2
    conv = 2 * frames * n_mels * 3 * d + 2 * s * d * 3 * d
    layer = 2 * s * 4 * d * d + 2 * s * 2 * d * 4 * d + 4 * s * s * d
    return windows * (conv + layers * layer)


def whisper_cross_kv_flops(windows: int, d: int, layers: int, s: int = 1500) -> float:
    """The decoder's cross-attention keys and values, once per window."""
    return windows * layers * 2 * (2 * s * d * d)


def whisper_decode_step_flops(rows: int, pos: int, d: int, layers: int, vocab: int,
                              s_audio: int = 1500) -> float:
    """One decoder step of `rows` rows at position `pos` (a cache of pos + 1
    keys): self-attention projections and scores, the cross-attention query,
    output and scores, the MLP, and the tied logits."""
    per_layer = (2 * 4 * d * d + 4 * (pos + 1) * d
                 + 2 * 2 * d * d + 4 * s_audio * d
                 + 2 * 2 * d * 4 * d)
    return rows * (layers * per_layer + 2 * d * vocab)


# -- MiniLM and the index -----------------------------------------------------------


def minilm_flops(tokens: int, d: int = 384, layers: int = 6, ffn: int = 1536) -> float:
    """MiniLM over one text of `tokens` real tokens: per layer the four
    projections, attention over those tokens and the FFN."""
    n = tokens
    per_layer = 2 * n * 4 * d * d + 2 * n * 2 * d * ffn + 4 * n * n * d
    return layers * per_layer


def ivf_probe_flops(clusters: int, probed_rows: float, d: int = 384) -> float:
    """One IVF search: the query against every centroid, then against the
    rows of the probed clusters."""
    return 2.0 * d * (clusters + probed_rows)
