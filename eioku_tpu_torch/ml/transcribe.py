"""Transcription: audio -> 30 s windows -> batched encode -> decode ->
transcript segments (port of eioku_tpu/ml/transcribe.py).

Fixed 30 s windows (silent ones dropped by the VAD) are batched through one
encoder call (K3 in every layer on the card) and one `whisper_decode_windows`
call per batch; a window whose decode is low-confidence or repetitive is
re-decoded with sampling chains at rising temperatures (faster-whisper's
fallback ladder, pretrained weights only).

Checkpoints: `{cache_dir}/whisper-{variant}.npz|.pt|.bin`. Without one, the
model falls back to a random-weight `tiny` (or the full variant with
`random_full_size`), which emits no rows, as in the JAX package.

Not ported yet, each refused with ModelNotAvailable: int8 compute types
(ops/quant.py), tensor_parallel > 1, draft_model (speculative decoding),
word_timestamps and condition_on_previous_text where they would take effect.
"""
from __future__ import annotations

import logging
import math
import os
from functools import lru_cache

import numpy as np
import torch

from eioku_tpu_torch.ml import audio_io
from eioku_tpu_torch.ml.engine import ModelNotAvailable
from eioku_tpu_torch.models.whisper.decoding import (
    build_suppress_masks,
    whisper_decode_windows,
)
from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
from eioku_tpu_torch.models.whisper.model import (
    WhisperConfig,
    init_whisper,
    whisper_detect_language,
    whisper_encode,
)
from eioku_tpu_torch.models.whisper.tokenizer import (
    LANGUAGES,
    WhisperTextDecoder,
    WhisperTextEncoder,
    WhisperTokens,
)
from eioku_tpu_torch.models.whisper.weights import load_whisper_checkpoint
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

WINDOW_S = 30.0
SAMPLES_PER_WINDOW = int(WINDOW_S * audio_io.SAMPLE_RATE)
COMPUTE_DTYPES = ("float32", "bfloat16")


@lru_cache(maxsize=2)
def _load_model(variant: str, cache_dir: str | None,
                compute_dtype: str = "float32",
                random_full_size: bool = False,
                device: torch.device = torch.device("cpu")):
    """Load (or random-init) whisper weights, stored in compute_dtype on
    `device`. Returns (model, cfg, pretrained)."""
    cfg = WhisperConfig(variant, compute_dtype=compute_dtype)
    model = None
    pretrained = False
    if cache_dir:
        for ext in (".npz", ".pt", ".bin"):
            cand = os.path.join(cache_dir, f"whisper-{variant}{ext}")
            if os.path.isfile(cand):
                model = load_whisper_checkpoint(cand, cfg, device)
                log.info("loaded whisper checkpoint", extra={"path": cand})
                pretrained = True
                break
    if model is None:
        if variant != "tiny" and not random_full_size:
            # random weights emit garbage either way: don't spend a large
            # variant's memory on them unless asked (benchmarks set
            # random_full_size to measure the real architecture's cost)
            log.warning("no whisper checkpoint for %s; falling back to "
                        "random tiny", variant)
            cfg = WhisperConfig("tiny", compute_dtype=compute_dtype)
        gen = torch.Generator(device=device).manual_seed(0)
        model = init_whisper(cfg, gen, device)
    return model.to(cfg.dtype).eval(), cfg, pretrained


def _normalize_variant(model: str) -> str:
    name = model.removeprefix("whisper-")
    return name if name in ("tiny", "base", "small", "medium", "large-v3",
                            "large-v3-turbo") else "large-v3"


def parse_timestamped_tokens(gen: list[int], tokens, text_decoder,
                             window_start_ms: int, window_end_ms: int
                             ) -> list[dict]:
    """Split a decoded token stream at Whisper timestamp tokens into segments.

    Timestamp tokens encode 0.02 s steps from the window start; text between
    a pair of timestamps becomes one segment. Text outside any timestamp pair
    falls back to the window span."""
    segments: list[dict] = []
    seg_start_s: float | None = None
    buf: list[int] = []

    def flush(end_s: float | None) -> None:
        nonlocal buf, seg_start_s
        if not buf:
            seg_start_s = None
            return
        text = text_decoder.decode(buf)
        if text:
            s_ms = window_start_ms + int((seg_start_s or 0.0) * 1000)
            e_ms = window_start_ms + int(end_s * 1000) if end_s is not None \
                else window_end_ms
            e_ms = max(min(e_ms, window_end_ms), s_ms)
            segments.append({"text": text, "start_ms": s_ms, "end_ms": e_ms})
        buf = []
        seg_start_s = None

    for tok in gen:
        ts = tokens.timestamp_seconds(tok)
        if ts is not None:
            if buf:
                flush(ts)
            else:
                seg_start_s = ts
        elif not tokens.is_special(tok):
            buf.append(tok)
    flush(None)
    return segments


def decoded_text(row_ids: list[int], prompt_len: int, tokens,
                 text_decoder) -> str:
    """Plain text of one decoded row (prompt stripped, EOT-truncated)."""
    gen = row_ids[prompt_len:]
    if tokens.eot in gen:
        gen = gen[:gen.index(tokens.eot)]
    return text_decoder.decode([t for t in gen if not tokens.is_special(t)])


def compression_ratio(text: str) -> float:
    """zlib compressibility of the transcript (> 2.4 marks a looping decode)."""
    import zlib

    raw = text.encode("utf-8")
    if not raw:
        return 0.0
    return len(raw) / len(zlib.compress(raw))


def needs_temperature_fallback(avg_lp: float, no_speech_prob: float,
                               text: str, logprob_threshold: float,
                               no_speech_threshold: float,
                               cr_threshold: float) -> bool:
    """faster-whisper's retry predicate. Confident silence (high no-speech
    prob AND a weak transcript) is exempt: the silence gate drops it."""
    if no_speech_prob > no_speech_threshold and avg_lp < logprob_threshold:
        return False
    if avg_lp < logprob_threshold:
        return True
    return compression_ratio(text) > cr_threshold


def _refuse_unported(config: dict) -> str:
    """The compute dtype to load, after refusing the options this port does
    not implement yet (those that take effect whatever the weights)."""
    variant = _normalize_variant(config.get("model", "large-v3"))
    # int8 is the JAX package's default for the turbo variant
    default_cd = "int8" if variant == "large-v3-turbo" else "bfloat16"
    cd = str(config.get("compute_dtype", default_cd))
    if cd.lower().startswith("int8"):
        raise ModelNotAvailable(
            f"compute_dtype {cd!r} (int8 weight quantization, ops/quant.py) is "
            "not ported to eioku_tpu_torch yet")
    if cd not in COMPUTE_DTYPES:
        raise ModelNotAvailable(f"compute_dtype {cd!r} is not supported; "
                                f"use one of {COMPUTE_DTYPES}")
    if int(config.get("tensor_parallel", 1)) > 1:
        raise ModelNotAvailable("tensor_parallel > 1 (tensor-parallel whisper) "
                                "is not ported to eioku_tpu_torch yet")
    return cd


def run_transcription(video_path: str, config: dict,
                      model_cache_dir: str | None = None,
                      device: str | torch.device | None = None) -> list[dict]:
    dev = resolve_device(device)
    compute_dtype = _refuse_unported(config)
    audio_path = audio_io.find_audio_for_video(video_path)
    if audio_path is None:
        log.warning("no audio stream available for %s (no wav/mp3/ogg/flac "
                    "sidecar); emitting empty transcript", video_path)
        return []
    audio = audio_io.load_audio(audio_path)
    if len(audio) == 0:
        return []
    language = config.get("language")
    vad = bool(config.get("vad_filter", True))
    windows = audio_io.split_windows(audio, window_s=WINDOW_S, vad=vad,
                                     model_cache_dir=model_cache_dir)
    if not windows:
        return []

    variant = _normalize_variant(config.get("model", "large-v3"))
    model, cfg, pretrained = _load_model(
        variant, model_cache_dir, compute_dtype,
        bool(config.get("random_full_size", False)), dev)
    tokens = WhisperTokens(cfg.vocab_size)
    text_decoder = WhisperTextDecoder.from_cache_dir(model_cache_dir,
                                                     cfg.vocab_size)
    if config.get("draft_model") and pretrained:
        raise ModelNotAvailable("draft_model (speculative decoding) is not "
                                "ported to eioku_tpu_torch yet")
    if bool(config.get("condition_on_previous_text", False)) and pretrained:
        raise ModelNotAvailable("condition_on_previous_text (the serial "
                                "conditioned decode) is not ported to "
                                "eioku_tpu_torch yet")
    if (bool(config.get("word_timestamps", False)) and pretrained
            and text_decoder.id_to_token is not None):
        raise ModelNotAvailable("word_timestamps (cross-attention alignment) "
                                "is not ported to eioku_tpu_torch yet")

    # segment-level timestamps need a real model; random weights use plain mode
    want_ts = config.get("timestamps", "auto")
    use_timestamps = pretrained if want_ts == "auto" else bool(want_ts)

    def mel_of(wav: np.ndarray) -> torch.Tensor:
        return log_mel_spectrogram(torch.from_numpy(wav).to(dev), n_mels=cfg.n_mels)

    if language is None and pretrained:
        # auto-detect from the first voiced window
        first_enc = whisper_encode(model, mel_of(windows[0][1][None]))
        language = LANGUAGES[int(whisper_detect_language(model, first_enc)[0])]
        log.info("auto-detected language", extra={"language": language})
    task = str(config.get("task", "transcribe"))
    if task not in ("transcribe", "translate"):
        log.warning("unknown whisper task %r; transcribing", task)
        task = "transcribe"
    sot = tokens.sot_sequence(language or "en", timestamps=use_timestamps,
                              task=task)

    # initial prompt and hotwords ride as sot_prev left context, capped at
    # half the 448-token decoder context minus the sot_prev slot
    prompt_text = str(config.get("initial_prompt") or "")
    hot = config.get("hotwords") or config.get("custom_vocabulary")
    if hot:
        hot_text = ", ".join(hot) if isinstance(hot, (list, tuple)) else str(hot)
        prompt_text = (prompt_text + " " + hot_text).strip()
    prompt_ids: list[int] = []
    if prompt_text and pretrained:
        prompt_ids = WhisperTextEncoder.from_cache_dir(
            model_cache_dir).encode(" " + prompt_text.strip())[-(448 // 2 - 1):]
        if not prompt_ids:
            log.warning("initial_prompt/custom_vocabulary set but no "
                        "vocab.json under the model cache; prompt disabled")
    init_seq = ([tokens.sot_prev] + prompt_ids if prompt_ids else []) + sot
    sot_index = len(init_seq) - len(sot)

    batch_size = int(config.get("batch_size", 8))
    max_tokens = int(config.get("max_tokens", 128))
    # faster-whisper's defaults: beam 5, no_speech_threshold 0.6,
    # logprob_threshold -1.0; random weights decode greedily
    beam_size = int(config.get("beam_size", 5)) if pretrained else 1
    no_speech_threshold = float(config.get("no_speech_threshold", 0.6))
    logprob_threshold = float(config.get("logprob_threshold", -1.0))
    temperatures = tuple(config.get("temperatures",
                                    (0.2, 0.4, 0.6, 0.8, 1.0))) \
        if pretrained else ()
    cr_threshold = float(config.get("compression_ratio_threshold", 2.4))
    suppress_always, suppress_begin = build_suppress_masks(
        tokens, timestamps=use_timestamps,
        non_speech=bool(config.get("suppress_non_speech", True)))
    total_ms = int(len(audio) / audio_io.SAMPLE_RATE * 1000)
    results: list[dict] = []

    def emit_window(row_ids: list[int], prompt_len: int, avg_lp_j: float,
                    no_speech_j: float, start_ms: int) -> None:
        """Post-process one decoded window row into transcript rows."""
        gen = row_ids[prompt_len:]
        if tokens.eot in gen:
            gen = gen[:gen.index(tokens.eot)]
        end_ms = min(start_ms + int(WINDOW_S * 1000), total_ms)
        if not pretrained:
            return  # random weights produce arbitrary ids; suppress text
        if no_speech_j > no_speech_threshold and avg_lp_j < logprob_threshold:
            return  # silence gate: confident no-speech AND a weak transcript
        confidence = float(min(1.0, max(0.0, math.exp(avg_lp_j))))
        segs = []
        if use_timestamps:
            segs = parse_timestamped_tokens(gen, tokens, text_decoder,
                                            start_ms, end_ms)
        if not segs:
            text = text_decoder.decode(gen)
            if text:
                segs = [{"text": text, "start_ms": start_ms, "end_ms": end_ms}]
        for seg in segs:
            results.append({
                "payload": {"text": seg["text"], "language": language,
                            "start_ms": seg["start_ms"],
                            "end_ms": seg["end_ms"],
                            "confidence": confidence, "words": []},
                "span_start_ms": seg["start_ms"],
                "span_end_ms": seg["end_ms"],
            })

    decode_kw = dict(max_len=max_tokens + sot_index, beam_size=beam_size,
                     timestamps=use_timestamps, sot_index=sot_index)
    for i in range(0, len(windows), batch_size):
        chunk = windows[i:i + batch_size]
        pad = batch_size - len(chunk)
        wav = np.stack([c[1] for c in chunk] +
                       [np.zeros(SAMPLES_PER_WINDOW, np.float32)] * pad)
        enc = whisper_encode(model, mel_of(wav))
        init = torch.tensor([init_seq] * batch_size, dtype=torch.long, device=dev)
        out, avg_lp, no_speech = whisper_decode_windows(
            model, enc, init, suppress_always, suppress_begin, **decode_kw)
        out = out.cpu().numpy()
        avg_lp = avg_lp.cpu().numpy()
        no_speech = no_speech.cpu().numpy()

        def _fallback_needed(j: int) -> bool:
            return needs_temperature_fallback(
                float(avg_lp[j]), float(no_speech[j]),
                decoded_text(out[j].tolist(), len(init_seq), tokens,
                             text_decoder),
                logprob_threshold, no_speech_threshold, cr_threshold)

        failed = [j for j in range(len(chunk)) if _fallback_needed(j)] \
            if temperatures else []
        for ti, temp in enumerate(temperatures):
            if not failed:
                break
            # re-decode the whole batch with sampling chains at this
            # temperature and adopt the new rows for the failed windows only;
            # the last rung is adopted unconditionally (the gate still applies)
            gen = torch.Generator(device=dev).manual_seed((i << 8) | ti)
            out_t, lp_t, _ = whisper_decode_windows(
                model, enc, init, suppress_always, suppress_begin, **decode_kw,
                sample=True, temperature=temp, generator=gen)
            out[failed] = out_t.cpu().numpy()[failed]
            avg_lp[failed] = lp_t.cpu().numpy()[failed]
            failed = [j for j in failed if _fallback_needed(j)]
            log.info("temperature fallback", extra={
                "temperature": temp, "remaining": len(failed)})
        for j, (start_ms, _) in enumerate(chunk):
            emit_window(out[j].tolist(), len(init_seq), float(avg_lp[j]),
                        float(no_speech[j]), start_ms)
        progress.report((i + len(chunk)) / len(windows))
    return results
