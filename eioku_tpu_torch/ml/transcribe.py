"""Transcription: audio -> 30 s windows -> batched encode -> decode ->
transcript segments (port of eioku_tpu/ml/transcribe.py).

Fixed 30 s windows (silent ones dropped by the VAD) are batched through one
encoder call (K3 in every layer on the card) and one `whisper_decode_windows`
call per batch; a window whose decode is low-confidence or repetitive is
re-decoded with sampling chains at rising temperatures (faster-whisper's
fallback ladder, pretrained weights only).

Options, as in the JAX package:
- `compute_dtype` "int8" (any int8* name; the default of large-v3-turbo):
  bf16 weights with every linear quantized to int8 (ops/quant.py), once per
  process;
- `word_timestamps`: one teacher-forced pass per batch collects the
  cross-attention alignment (`cross_attention_alignment`), and DTW on the
  host times each word (models/whisper/align.py); each word goes to the
  segment holding its midpoint;
- `condition_on_previous_text`: a serial decode, window by window, with the
  tail of the previous text as sot_prev context (`_run_conditioned`);
- `draft_model` / `speculative_gamma`: speculative greedy decoding with a
  draft checkpoint (models/whisper/speculative.py), where it is eligible;
- `compute_dtype` "float16" (faster-whisper's usual GPU compute type) or
  "bfloat16" (the default) or "float32": weights and activations in that
  type, K3 in the encoder on the card in the 16-bit types;
- `tensor_parallel` N > 1: where the JAX package shards (at least N
  devices in `parallel/mesh.local_devices`, n_heads divisible by N, no
  draft model, no conditioned decode) the weights are cut into N Megatron
  shards over a (1, N) mesh once per loaded model and kept with it, and
  every batch goes through `whisper_encode_tp` (K3 on each shard's heads)
  and `whisper_decode_windows_tp`; int8 then keeps 16-bit weights, with the
  JAX package's warning. Everywhere else the JAX package's warning and the
  one-device decode. One card listed N times runs the shards one after
  the other.
The options that change the decode take effect only with a checkpoint.

Checkpoints: `{cache_dir}/whisper-{variant}.npz|.pt|.bin`. Without one, the
model falls back to a random-weight `tiny` (or the full variant with
`random_full_size`), which emits no rows, as in the JAX package.
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
from eioku_tpu_torch.models.layers import quantize_linears
from eioku_tpu_torch.models.whisper.align import word_timestamps
from eioku_tpu_torch.models.whisper.decoding import (
    build_suppress_masks,
    whisper_decode_windows,
    whisper_decode_windows_tp,
)
from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
from eioku_tpu_torch.models.whisper.model import (
    WhisperConfig,
    cross_attention_alignment,
    init_whisper,
    shard_whisper,
    whisper_detect_language,
    whisper_encode,
    whisper_encode_tp,
)
from eioku_tpu_torch.models.whisper.speculative import (
    score_sequences,
    speculative_greedy_decode,
)
from eioku_tpu_torch.models.whisper.tokenizer import (
    LANGUAGES,
    WhisperTextDecoder,
    WhisperTextEncoder,
    WhisperTokens,
)
from eioku_tpu_torch.models.whisper.weights import load_whisper_checkpoint
from eioku_tpu_torch.parallel import mesh as mesh_lib
from eioku_tpu_torch.utils import progress
from eioku_tpu_torch.utils.device import resolve_device
from eioku_tpu_torch.utils.metrics import METRICS

log = logging.getLogger(__name__)

WINDOW_S = 30.0
SAMPLES_PER_WINDOW = int(WINDOW_S * audio_io.SAMPLE_RATE)
COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


@lru_cache(maxsize=2)
def _load_model(variant: str, cache_dir: str | None,
                compute_dtype: str = "float32",
                random_full_size: bool = False,
                device: torch.device = torch.device("cpu")):
    """Load (or random-init) whisper weights, stored in compute_dtype on
    `device`; "int8" stores bf16 and then quantizes every linear (the JAX
    package's `_load_model_int8`), so the post-training quantization runs
    once per process, not once per task. Returns (model, cfg, pretrained)."""
    int8 = compute_dtype == "int8"
    cfg = WhisperConfig(variant, compute_dtype="bfloat16" if int8 else compute_dtype)
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
            cfg = WhisperConfig("tiny", compute_dtype=cfg.compute_dtype)
        gen = torch.Generator(device=device).manual_seed(0)
        model = init_whisper(cfg, gen, device)
    model = model.to(cfg.dtype).eval()
    if int8:
        quantize_linears(model)
    return model, cfg, pretrained


@lru_cache(maxsize=2)
def _tp_shards(model, devices: tuple[torch.device, ...]):
    """The model's Megatron shards over a (1, len(devices)) mesh, made once
    per loaded model and devices."""
    return shard_whisper(model, mesh_lib.Mesh([list(devices)]))


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


def _load_dtype(config: dict) -> str:
    """The compute type `_load_model` loads: "int8" for any int8* name (the
    turbo variant's default, as in the JAX package), else float32 or
    bfloat16 or float16. Raises ModelNotAvailable for other types."""
    variant = _normalize_variant(config.get("model", "large-v3"))
    default_cd = "int8" if variant == "large-v3-turbo" else "bfloat16"
    cd = str(config.get("compute_dtype", default_cd))
    if cd.lower().startswith("int8"):
        return "int8"
    if cd not in COMPUTE_DTYPES:
        raise ModelNotAvailable(f"compute_dtype {cd!r} is not supported; "
                                f"use one of {COMPUTE_DTYPES} or int8")
    return cd


def run_transcription(video_path: str, config: dict,
                      model_cache_dir: str | None = None,
                      device: str | torch.device | None = None) -> list[dict]:
    dev = resolve_device(device)
    load_dtype = _load_dtype(config)
    with METRICS.span("audio.find"):
        audio_path = audio_io.find_audio_for_video(video_path)
    if audio_path is None:
        log.warning("no audio stream available for %s (no wav/mp3/ogg/flac "
                    "sidecar); emitting empty transcript", video_path)
        return []
    with METRICS.span("audio.load"):
        audio = audio_io.load_audio(audio_path)
    if len(audio) == 0:
        return []
    language = config.get("language")
    vad = bool(config.get("vad_filter", True))
    with METRICS.span("audio.windows"):
        windows = audio_io.split_windows(audio, window_s=WINDOW_S, vad=vad,
                                         model_cache_dir=model_cache_dir, device=dev)
    if not windows:
        return []

    variant = _normalize_variant(config.get("model", "large-v3"))
    with METRICS.span("load_model"):
        model, cfg, pretrained = _load_model(
            variant, model_cache_dir, load_dtype,
            bool(config.get("random_full_size", False)), dev)
    tokens = WhisperTokens(cfg.vocab_size)
    text_decoder = WhisperTextDecoder.from_cache_dir(model_cache_dir,
                                                     cfg.vocab_size)

    # segment-level timestamps need a real model; random weights use plain mode
    want_ts = config.get("timestamps", "auto")
    use_timestamps = pretrained if want_ts == "auto" else bool(want_ts)

    def mel_of(wav: np.ndarray) -> torch.Tensor:
        return log_mel_spectrogram(torch.from_numpy(wav).to(dev), n_mels=cfg.n_mels)

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
    # speculative decoding: a draft checkpoint proposes, this model verifies;
    # the output is this model's own greedy decode. Eligible only for plain
    # greedy decoding (the config checks come before the draft's load)
    spec_draft = None
    draft_model = config.get("draft_model")
    if draft_model and pretrained:
        eligible = False
        if (int(config.get("beam_size", 5)) == 1 and not use_timestamps
                and not prompt_ids):
            # the draft loads bf16 when the target is int8
            d_model, d_cfg, d_pre = _load_model(
                _normalize_variant(str(draft_model)), model_cache_dir,
                "bfloat16" if load_dtype == "int8" else load_dtype, False, dev)
            eligible = d_pre and d_cfg.vocab_size == cfg.vocab_size
        if eligible:
            spec_draft = d_model
        else:
            log.warning("draft_model set but speculative decoding needs a "
                        "pretrained same-vocab draft, beam_size=1, "
                        "timestamps off, and no initial prompt; using the "
                        "standard decode")
    # previous-text conditioning runs the serial one-device decode
    conditioned = (bool(config.get("condition_on_previous_text", False))
                   and pretrained)
    tp = int(config.get("tensor_parallel", 1))
    shards = None
    if tp > 1:
        if (len(mesh_lib.local_devices(dev)) >= tp and cfg.n_heads % tp == 0
                and spec_draft is None and not conditioned):
            if load_dtype == "int8":
                log.warning("compute_dtype int8 is single-device; the "
                            "tensor_parallel path keeps bf16 weights")
                model, cfg, pretrained = _load_model(
                    variant, model_cache_dir, "bfloat16",
                    bool(config.get("random_full_size", False)), dev)
            # cut the weights once per loaded model: re-sharding on every
            # batch would copy the whole tree to the devices each time
            shards = _tp_shards(model, tuple(mesh_lib.local_devices(dev)[:tp]))
            log.info("tensor-parallel transcription", extra={"tp": tp})
        else:
            log.warning("tensor_parallel=%d needs >=%d devices, "
                        "n_heads %% tp == 0, no draft_model, and "
                        "condition_on_previous_text off (serial decode); "
                        "falling back to single-device decode", tp, tp)
    if load_dtype == "int8" and shards is None:
        log.info("int8-quantized whisper serving",
                 extra={"compute_type": config.get("compute_dtype", "int8")})

    if language is None and pretrained:
        # auto-detect from the first voiced window
        with METRICS.span("lang_detect"):
            first_enc = whisper_encode(model, mel_of(windows[0][1][None]))
            language = LANGUAGES[int(whisper_detect_language(model, first_enc)[0])]
        METRICS.count("window_slots")
        log.info("auto-detected language", extra={"language": language})
    task = str(config.get("task", "transcribe"))
    if task not in ("transcribe", "translate"):
        log.warning("unknown whisper task %r; transcribing", task)
        task = "transcribe"
    sot = tokens.sot_sequence(language or "en", timestamps=use_timestamps,
                              task=task)
    init_seq = ([tokens.sot_prev] + prompt_ids if prompt_ids else []) + sot
    sot_index = len(init_seq) - len(sot)

    def encode(mel: torch.Tensor) -> torch.Tensor:
        return whisper_encode(model, mel) if shards is None else whisper_encode_tp(shards, mel)

    def decode(enc: torch.Tensor, init: torch.Tensor, **kw):
        if shards is None:
            return whisper_decode_windows(model, enc, init, suppress_always,
                                          suppress_begin, **kw)
        return whisper_decode_windows_tp(shards, enc, init, suppress_always,
                                         suppress_begin, **kw)

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
    # word timings need a real checkpoint AND a real vocabulary to group
    # byte-BPE tokens into words
    want_words = (bool(config.get("word_timestamps", False)) and pretrained
                  and text_decoder.id_to_token is not None)
    total_ms = int(len(audio) / audio_io.SAMPLE_RATE * 1000)
    results: list[dict] = []

    def emit_window(row_ids: list[int], prompt_len: int, avg_lp_j: float,
                    no_speech_j: float, start_ms: int,
                    align_row: np.ndarray | None) -> list[int] | None:
        """Post-process one decoded window row into transcript rows. Returns
        its text tokens (the conditioned decode's next context), or None
        when the window was gated."""
        gen = row_ids[prompt_len:]
        if tokens.eot in gen:
            gen = gen[:gen.index(tokens.eot)]
        end_ms = min(start_ms + int(WINDOW_S * 1000), total_ms)
        if not pretrained:
            return None  # random weights produce arbitrary ids; suppress text
        if no_speech_j > no_speech_threshold and avg_lp_j < logprob_threshold:
            return None  # silence gate: confident no-speech AND a weak transcript
        confidence = float(min(1.0, max(0.0, math.exp(avg_lp_j))))
        segs = []
        if use_timestamps:
            segs = parse_timestamped_tokens(gen, tokens, text_decoder,
                                            start_ms, end_ms)
        if not segs:
            text = text_decoder.decode(gen)
            if text:
                segs = [{"text": text, "start_ms": start_ms, "end_ms": end_ms}]
        words: list[dict] = []
        if align_row is not None and gen:
            words = word_timestamps(
                align_row[prompt_len:prompt_len + len(gen)], gen, text_decoder,
                start_ms, max((end_ms - start_ms) // 20, 1))
        # each word goes to one segment: the one holding its midpoint (else
        # the nearest boundary's)
        seg_words: dict[int, list[dict]] = {k: [] for k in range(len(segs))}
        for w in words if segs else []:
            mid = (w["start_ms"] + w["end_ms"]) // 2
            best = min(range(len(segs)), key=lambda k: (
                0 if segs[k]["start_ms"] <= mid < segs[k]["end_ms"]
                else min(abs(mid - segs[k]["start_ms"]),
                         abs(mid - segs[k]["end_ms"]))))
            seg_words[best].append(w)
        for k, seg in enumerate(segs):
            results.append({
                "payload": {"text": seg["text"], "language": language,
                            "start_ms": seg["start_ms"],
                            "end_ms": seg["end_ms"],
                            "confidence": confidence, "words": seg_words[k]},
                "span_start_ms": seg["start_ms"],
                "span_end_ms": seg["end_ms"],
            })
        return [t for t in gen if not tokens.is_special(t)]

    def frame_count(start_ms: int) -> int:
        return max((min(start_ms + int(WINDOW_S * 1000), total_ms)
                    - start_ms) // 20, 1)

    def alignment(rows: np.ndarray, enc: torch.Tensor, starts: list[int]) -> np.ndarray:
        """[B, S, 1500] alignment energy of decoded rows (frame counts keep
        the statistics off each window's zero-padded tail)."""
        counts = torch.full((len(rows),), 1500, dtype=torch.int32)
        counts[:len(starts)] = torch.tensor([frame_count(s) for s in starts],
                                            dtype=torch.int32)
        return cross_attention_alignment(
            model, torch.from_numpy(rows).to(dev), enc, counts.to(dev)).cpu().numpy()

    if conditioned:
        # the serial decode with previous-text context (faster-whisper's
        # default mode); the batched path below is this port's default
        _run_conditioned(windows, model, tokens, sot, suppress_always,
                         suppress_begin, max_tokens, beam_size, use_timestamps,
                         want_words, emit_window, alignment, text_decoder,
                         temperatures, (logprob_threshold, no_speech_threshold,
                                        cr_threshold), mel_of,
                         initial_prev=prompt_ids)
        return results

    decode_kw = dict(max_len=max_tokens + sot_index, beam_size=beam_size,
                     timestamps=use_timestamps, sot_index=sot_index)
    for i in range(0, len(windows), batch_size):
        chunk = windows[i:i + batch_size]
        pad = batch_size - len(chunk)
        with METRICS.span("mel"):
            wav = np.stack([c[1] for c in chunk] +
                           [np.zeros(SAMPLES_PER_WINDOW, np.float32)] * pad)
            mel = mel_of(wav)
        METRICS.count("window_slots", batch_size)
        METRICS.count("padded_slots", pad)
        with METRICS.span("encode"):
            enc = encode(mel)
        with METRICS.span("decode"):
            init = torch.tensor([init_seq] * batch_size, dtype=torch.long, device=dev)
            if spec_draft is not None:
                d_enc = whisper_encode(spec_draft, mel)
                out, accept_rate = speculative_greedy_decode(
                    model, spec_draft, enc, d_enc, init, suppress_always,
                    suppress_begin, max_len=max_tokens + sot_index,
                    gamma=int(config.get("speculative_gamma", 4)))
                avg_lp, no_speech = score_sequences(
                    model, enc, out, len(init_seq), suppress_always, suppress_begin)
                log.info("speculative decode",
                         extra={"accept_rate": round(accept_rate, 3)})
            else:
                out, avg_lp, no_speech = decode(enc, init, **decode_kw)
        with METRICS.span("copy_back"):
            out = out.cpu().numpy()
            avg_lp = avg_lp.cpu().numpy()
            no_speech = no_speech.cpu().numpy()

        def _fallback_needed(j: int) -> bool:
            return needs_temperature_fallback(
                float(avg_lp[j]), float(no_speech[j]),
                decoded_text(out[j].tolist(), len(init_seq), tokens,
                             text_decoder),
                logprob_threshold, no_speech_threshold, cr_threshold)

        with METRICS.span("fallback"):
            failed = [j for j in range(len(chunk)) if _fallback_needed(j)] \
                if temperatures else []
            for ti, temp in enumerate(temperatures):
                if not failed:
                    break
                # re-decode the whole batch with sampling chains at this
                # temperature and adopt the new rows for the failed windows
                # only; the last rung is adopted unconditionally (the gate
                # still applies)
                gen = torch.Generator(device=dev).manual_seed((i << 8) | ti)
                out_t, lp_t, _ = decode(enc, init, **decode_kw, sample=True,
                                        temperature=temp, generator=gen)
                out[failed] = out_t.cpu().numpy()[failed]
                avg_lp[failed] = lp_t.cpu().numpy()[failed]
                failed = [j for j in failed if _fallback_needed(j)]
                log.info("temperature fallback", extra={
                    "temperature": temp, "remaining": len(failed)})
        with METRICS.span("rows"):
            # one teacher-forced pass over the (adopted) rows for the words
            align = alignment(out, enc, [s for s, _ in chunk]) if want_words else None
            for j, (start_ms, _) in enumerate(chunk):
                emit_window(out[j].tolist(), len(init_seq), float(avg_lp[j]),
                            float(no_speech[j]), start_ms,
                            align[j] if align is not None else None)
        progress.report((i + len(chunk)) / len(windows))
    return results


# previous-context budgets: the context is cut to the largest of these that
# it fills (the JAX package's compile buckets)
_PROMPT_BUCKETS = (0, 16, 32, 64, 128)


def _run_conditioned(windows, model, tokens, sot, suppress_always,
                     suppress_begin, max_tokens, beam_size, use_timestamps,
                     want_words, emit_window, alignment, text_decoder,
                     temperatures, thresholds, mel_of,
                     initial_prev: list[int] | None = None) -> None:
    """Serial decode with previous-text conditioning (faster-whisper's
    condition_on_previous_text): each window's prompt is [sot_prev] + the
    tail of the previous text + the SOT sequence. The context resets after a
    gated window; `initial_prev` (the initial prompt and hotwords) seeds
    window 0's. The fallback ladder draws from a generator seeded
    (window << 8) | rung."""
    logprob_threshold, no_speech_threshold, cr_threshold = thresholds
    dev = next(model.parameters()).device
    prev: list[int] = list(initial_prev or [])
    for w_idx, (start_ms, wav) in enumerate(windows):
        bucket = max((b for b in _PROMPT_BUCKETS if b <= len(prev)), default=0)
        if bucket:
            ctx = prev[-bucket:]
        elif w_idx == 0 and prev:
            ctx = prev  # an initial prompt shorter than the smallest bucket
        else:
            ctx = []
        prompt = ([tokens.sot_prev] + ctx if ctx else []) + sot
        with METRICS.span("mel"):
            mel = mel_of(wav[None])
        METRICS.count("window_slots")
        with METRICS.span("encode"):
            enc = whisper_encode(model, mel)
        kw = dict(max_len=len(prompt) + max_tokens, beam_size=beam_size,
                  timestamps=use_timestamps,
                  sot_index=len(prompt) - len(sot))  # the gate reads SOT's step
        with METRICS.span("decode"):
            init = torch.tensor([prompt], dtype=torch.long, device=dev)
            out, avg_lp, no_speech = whisper_decode_windows(
                model, enc, init, suppress_always, suppress_begin, **kw)
        with METRICS.span("fallback"):
            for ti, temp in enumerate(temperatures):
                if not needs_temperature_fallback(
                        float(avg_lp[0]), float(no_speech[0]),
                        decoded_text(out[0].tolist(), len(prompt), tokens,
                                     text_decoder),
                        logprob_threshold, no_speech_threshold, cr_threshold):
                    break
                gen = torch.Generator(device=dev).manual_seed((w_idx << 8) | ti)
                out, avg_lp, _ = whisper_decode_windows(
                    model, enc, init, suppress_always, suppress_begin, **kw,
                    sample=True, temperature=temp, generator=gen)
        with METRICS.span("copy_back"):
            out = out.cpu().numpy()
        with METRICS.span("rows"):
            align = alignment(out, enc, [start_ms]) if want_words else None
            gen_text = emit_window(out[0].tolist(), len(prompt), float(avg_lp[0]),
                                   float(no_speech[0]), start_ms,
                                   align[0] if align is not None else None)
        if gen_text is None:
            prev = []  # reset the context after a gated window
        else:
            prev = (prev + gen_text)[-max(_PROMPT_BUCKETS):]
        progress.report((w_idx + 1) / len(windows))
