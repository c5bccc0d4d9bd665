"""The port's Whisper options against the JAX package's, on the CPU at fp32:
word timestamps (cross-attention alignment + models/whisper/align.py), the
conditioned decode and speculative decoding.

Both packages get the same seeded tiny trees (the JAX package's
`init_whisper_params`, carried across with `from_jax_params`), loaded as
checkpoints through a patched `_load_model`. `temperatures: []` keeps the
sampling ladder out of the row comparisons (torch.Generator and jax.random
draw different numbers). Tolerances, and why:
- alignment energy: 1e-5 absolute plus 1e-5 relative to the largest |z|
  (z-scores up to ~40 from fp32 softmaxes over 1500 frames);
- score_sequences: 1e-5 (fp32 logsumexp over 51865 logits, other orders);
- tokens, accept rates, words and rows: equal; the confidence within 1e-4.
"""
import copy
import json
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.ml import transcribe as jax_transcribe
from eioku_tpu.models.whisper import align as jax_align
from eioku_tpu.models.whisper import model as jax_model
from eioku_tpu.models.whisper import speculative as jax_spec
from eioku_tpu.models.whisper.decoding import build_suppress_masks as jax_masks
from eioku_tpu.models.whisper.tokenizer import WhisperTextDecoder as JaxTextDecoder
from eioku_tpu.models.whisper.tokenizer import WhisperTokens as JaxTokens
from eioku_tpu_torch.ml import transcribe
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models.whisper import align, model, speculative
from eioku_tpu_torch.models.whisper.decoding import build_suppress_masks
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTextDecoder, WhisperTokens
from eioku_tpu_torch.models.whisper.weights import from_jax_params
from test_torch_ocr import single_torch_thread

TINY = model.WhisperConfig("tiny")
JAX_TINY = jax_model.WhisperConfig("tiny")
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: under the suite's parallel workers the
    per-step parallel regions of small ops (decode steps, the LSTM) wait on
    descheduled threads."""
    with single_torch_thread():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """{seed: (jax params, port model)} for the target (0) and drafts."""
    out = {}
    for seed in (0, 7):
        p = jax_model.init_whisper_params(JAX_TINY, seed=seed)
        out[seed] = (p, from_jax_params(_np(p), TINY))
    return out


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """65 s: a voiced window, a digitally silent one (dropped by the energy
    VAD), then 5 s of voice; a vocab.json of word-start pieces."""
    d = tmp_path_factory.mktemp("torch_whisper_options")
    rng = np.random.default_rng(0)
    t = np.arange(SR * 65) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)
    x[30 * SR:60 * SR] = 0.0
    with wave.open(str(d / "clip.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    vocab = {f"Ġw{i}" if i % 3 == 0 else f"p{i}": i for i in range(50257)}
    (d / "vocab.json").write_text(json.dumps(vocab))
    return d


@pytest.fixture(scope="module")
def enc_pair(trees):
    """Each seed's encoder states for the same random mel, from JAX (the
    port's decoder reads the same states)."""
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 80, 3000)).astype(np.float32) * 0.5
    return {seed: np.array(jax_model.whisper_encode(p, jnp.asarray(mel), JAX_TINY))
            for seed, (p, _) in trees.items()}


@pytest.mark.parametrize("counts", [None, (1500, 260)])
def test_cross_attention_alignment_matches_jax(trees, enc_pair, counts):
    jp, port = trees[0]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 5000, (2, 12)).astype(np.int64)
    want = np.asarray(jax_model.cross_attention_alignment(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray(enc_pair[0]), JAX_TINY,
        None if counts is None else jnp.asarray(counts, jnp.int32)))
    got = model.cross_attention_alignment(
        port, torch.from_numpy(toks), torch.from_numpy(enc_pair[0]),
        None if counts is None else torch.tensor(counts, dtype=torch.int32)).numpy()
    assert got.shape == want.shape == (2, 12, 1500)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 + 1e-5 * np.abs(want).max())
    if counts is not None:  # frames past a window's count carry nothing
        assert not got[1, :, 260:].any()


@pytest.mark.parametrize("native", [True, False])
def test_words_equal_on_identical_matrices(audio_dir, monkeypatch, native):
    """align.py is a copy, held AST-equal to the JAX module by
    tests/test_torch_host.py; on one matrix both give the same words."""
    if not native:  # the Python DTW recurrence on both sides
        monkeypatch.setattr(align, "_load_native", lambda: None)
        monkeypatch.setattr(jax_align, "_load_native", lambda: None)
    rng = np.random.default_rng(3)
    toks = [0, 1, 2, 3, 4, 5, 50257, 6, 9, 10]
    m = rng.standard_normal((len(toks), 1500)).astype(np.float32)
    for i in range(len(toks)):  # a diagonal band under the noise
        m[i, i * 40:(i + 1) * 40] += 3.0
    dec = WhisperTextDecoder.from_cache_dir(str(audio_dir), 51865)
    jdec = JaxTextDecoder.from_cache_dir(str(audio_dir), 51865)
    got = align.word_timestamps(m, toks, dec, 30000, 430)
    want = jax_align.word_timestamps(m, toks, jdec, 30000, 430)
    assert got == want and len(got) >= 3
    ti, fi = align.dtw_path(-m[:, :430])
    wti, wfi = jax_align.dtw_path(-m[:, :430])
    np.testing.assert_array_equal(ti, wti)
    np.testing.assert_array_equal(fi, wfi)


def _masks():
    return build_suppress_masks(WhisperTokens(TINY.vocab_size), timestamps=False), \
        jax_masks(JaxTokens(JAX_TINY.vocab_size), timestamps=False)


@pytest.mark.parametrize("d_seed", [0, 7])  # the target itself, and another tree
def test_speculative_matches_jax(trees, enc_pair, d_seed):
    (jt, pt), (jd, pd) = trees[0], trees[d_seed]
    (sa, sb), (jsa, jsb) = _masks()
    sot = np.array([JaxTokens(JAX_TINY.vocab_size).sot_sequence(
        "en", timestamps=False)] * 2)
    want, want_rate = jax_spec.speculative_greedy_decode(
        jt, JAX_TINY, jd, JAX_TINY, jnp.asarray(enc_pair[0]),
        jnp.asarray(enc_pair[d_seed]), jnp.asarray(sot, jnp.int32), jsa, jsb,
        max_len=20, gamma=3)
    got, rate = speculative.speculative_greedy_decode(
        pt, pd, torch.from_numpy(enc_pair[0]), torch.from_numpy(enc_pair[d_seed]),
        torch.from_numpy(sot), sa, sb, max_len=20, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rate == pytest.approx(float(want_rate), abs=1e-7)
    if d_seed == 0:
        assert rate > 0.9
    # scores of the decoded rows, the silence gate's two signals
    lp, ns = speculative.score_sequences(pt, torch.from_numpy(enc_pair[0]), got,
                                         sot.shape[1], sa, sb)
    wlp, wns = jax_spec.score_sequences(jt, JAX_TINY, jnp.asarray(enc_pair[0]),
                                        want, sot.shape[1], jsa, jsb)
    np.testing.assert_allclose(lp.numpy(), np.asarray(wlp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ns.numpy(), np.asarray(wns), rtol=0, atol=1e-5)


@pytest.fixture()
def pretrained(monkeypatch, trees):
    """Both packages load the seed-0 tree as the checkpoint, and the seed-7
    tree as the "base" draft."""
    def pick(variant):
        return trees[7 if variant == "base" else 0]
    monkeypatch.setattr(jax_transcribe, "_load_model",
                        lambda variant, *a, **kw: (pick(variant)[0], JAX_TINY, True))
    monkeypatch.setattr(transcribe, "_load_model",
                        lambda variant, *a, **kw: (pick(variant)[1], TINY, True))


def _rows(want, got):
    conf = lambda rows: [r["payload"].pop("confidence") for r in rows]  # noqa: E731
    np.testing.assert_allclose(conf(got), conf(want), rtol=0, atol=1e-4)
    assert got == want


@pytest.mark.parametrize("config", [
    # word timestamps on the beam-5 timestamped decode
    {"word_timestamps": True, "max_tokens": 14, "batch_size": 2},
    # conditioned decode, greedy without timestamps, with words
    {"condition_on_previous_text": True, "beam_size": 1, "timestamps": False,
     "word_timestamps": True, "max_tokens": 10},
    # conditioned decode seeded by an initial prompt, beam 2 with timestamps
    {"condition_on_previous_text": True, "beam_size": 2, "initial_prompt": "w3 w6",
     "max_tokens": 10},
    # speculative decoding with the other tree as the draft
    {"draft_model": "base", "speculative_gamma": 3, "beam_size": 1,
     "timestamps": False, "max_tokens": 12, "batch_size": 2},
])
def test_option_rows_equal_jax(audio_dir, pretrained, config):
    cfg = {"model": "tiny", "compute_dtype": "float32", "language": "en",
           "temperatures": [], "no_speech_threshold": 2.0, **config}
    wav, cache = str(audio_dir / "clip.wav"), str(audio_dir)
    want = jax_transcribe.run_transcription(wav, cfg, model_cache_dir=cache)
    got = InferenceEngine(model_cache_dir=cache, device="cpu").run_task(
        "transcription", wav, cfg)
    assert len(want) > 0
    if config.get("word_timestamps"):
        assert any(r["payload"]["words"] for r in want)
    _rows(want, got)


def test_speculative_path_is_taken(audio_dir, pretrained, monkeypatch):
    calls = []
    real = transcribe.speculative_greedy_decode

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[1])
        return out
    monkeypatch.setattr(transcribe, "speculative_greedy_decode", spy)
    cfg = {"model": "tiny", "compute_dtype": "float32", "language": "en",
           "temperatures": [], "no_speech_threshold": 2.0, "draft_model": "base",
           "beam_size": 1, "timestamps": False, "max_tokens": 8, "batch_size": 2}
    wav = str(audio_dir / "clip.wav")
    transcribe.run_transcription(wav, cfg, model_cache_dir=str(audio_dir), device="cpu")
    assert len(calls) == 1 and 0.0 <= calls[0] <= 1.0
    # beam search makes the draft ineligible: the standard decode runs
    transcribe.run_transcription(wav, {**cfg, "beam_size": 2},
                                 model_cache_dir=str(audio_dir), device="cpu")
    assert len(calls) == 1


def test_int8_target_loads_a_bf16_draft(audio_dir, monkeypatch, trees):
    seen = []

    def fake_load(variant, cache, dtype, *a):
        seen.append((variant, dtype))
        return copy.deepcopy(trees[7 if variant == "base" else 0][1]), TINY, True
    monkeypatch.setattr(transcribe, "_load_model", fake_load)
    transcribe.run_transcription(
        str(audio_dir / "clip.wav"),
        {"model": "tiny", "compute_dtype": "int8", "draft_model": "base",
         "beam_size": 1, "timestamps": False, "language": "en", "max_tokens": 4,
         "temperatures": [], "batch_size": 2},
        model_cache_dir=str(audio_dir), device="cpu")
    assert seen == [("tiny", "int8"), ("base", "bfloat16")]
