"""The port's transcription task against the JAX package's, on the CPU at fp32.

Both packages get the same seeded tiny tree as if it were a checkpoint
(`_load_model` monkeypatched on both sides, as tests/test_whisper.py does
for the pretrained path), so the decode runs beam search with timestamps,
the silence gate and language detection. `temperatures: []` keeps the
sampling ladder out of the comparison: torch.Generator and jax.random draw
different numbers. Rows must be equal; the confidence, exp(avg_logprob),
within 1e-4 (fp32 logsumexp over 51865 logits, summed in other orders).
"""
import json
import wave

import numpy as np
import pytest
import torch

import jax

from eioku_tpu.ml import audio_io as jax_audio_io
from eioku_tpu.ml import transcribe as jax_transcribe
from eioku_tpu.models.whisper.model import WhisperConfig as JaxWhisperConfig
from eioku_tpu.models.whisper.model import init_whisper_params
from eioku_tpu_torch.ml import audio_io, transcribe
from eioku_tpu_torch.ml.engine import InferenceEngine, ModelNotAvailable
from eioku_tpu_torch.models.whisper.model import WhisperConfig
from eioku_tpu_torch.models.whisper.weights import from_jax_params
from test_torch_ocr import single_torch_thread

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: under the suite's parallel workers the
    per-step parallel regions of small ops (decode steps, the VAD's LSTM)
    wait on descheduled threads."""
    with single_torch_thread():
        yield


def _write_wav(path, x, sr=SR, channels=1):
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """65 s: a voiced window, a digitally silent one (dropped by the energy
    VAD), then 5 s of voice; a vocab.json of word-start pieces, so decoded
    ids become text."""
    d = tmp_path_factory.mktemp("torch_transcribe")
    rng = np.random.default_rng(0)
    t = np.arange(SR * 65) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)
    x[30 * SR:60 * SR] = 0.0
    _write_wav(d / "clip.wav", x)
    (d / "vocab.json").write_text(json.dumps({f"Ġw{i}": i
                                              for i in range(50257)}))
    return d


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = JaxWhisperConfig("tiny")
    return init_whisper_params(cfg, seed=0), cfg


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    return from_jax_params(jax.tree.map(np.asarray, jax_tiny[0]),
                           WhisperConfig("tiny"))


@pytest.fixture()
def pretrained(monkeypatch, jax_tiny, port_tiny):
    """Both packages load the same seeded tree as a pretrained checkpoint."""
    monkeypatch.setattr(jax_transcribe, "_load_model",
                        lambda *a, **kw: (*jax_tiny, True))
    monkeypatch.setattr(transcribe, "_load_model",
                        lambda *a, **kw: (port_tiny, WhisperConfig("tiny"), True))


def _split_confidence(rows):
    return ([{**r, "payload": {k: v for k, v in r["payload"].items()
                               if k != "confidence"}} for r in rows],
            [r["payload"]["confidence"] for r in rows])


@pytest.mark.parametrize("config", [
    # auto-detected language, beam 5 with timestamps (the pretrained default)
    {"max_tokens": 16, "batch_size": 2},
    # greedy without timestamps, translate task, an initial prompt + hotwords
    {"language": "en", "beam_size": 1, "timestamps": False, "task": "translate",
     "initial_prompt": "w5 w6", "hotwords": ["w7"], "max_tokens": 12,
     "batch_size": 1},
])
def test_rows_equal_jax_on_the_same_tree(audio_dir, pretrained, config):
    cfg = {"model": "tiny", "compute_dtype": "float32", "temperatures": [],
           "no_speech_threshold": 2.0, **config}
    wav, cache = str(audio_dir / "clip.wav"), str(audio_dir)
    want = jax_transcribe.run_transcription(wav, cfg, model_cache_dir=cache)
    got = InferenceEngine(model_cache_dir=cache, device="cpu").run_task(
        "transcription", wav, cfg)
    assert len(want) > 0
    rows_w, conf_w = _split_confidence(want)
    rows_g, conf_g = _split_confidence(got)
    assert rows_g == rows_w
    np.testing.assert_allclose(conf_g, conf_w, rtol=0, atol=1e-4)
    # the silent window (30-60 s) is dropped; rows come from windows 0 and 60 s
    assert {r["span_start_ms"] // 30000 for r in got} <= {0, 2}


def test_temperature_ladder_runs(audio_dir, pretrained):
    # an impossible logprob threshold sends every window down the ladder;
    # the last rung's rows are adopted and emitted
    rows = transcribe.run_transcription(
        str(audio_dir / "clip.wav"),
        {"model": "tiny", "compute_dtype": "float32", "language": "en",
         "max_tokens": 10, "batch_size": 2, "beam_size": 2, "timestamps": False,
         "logprob_threshold": 0.0, "temperatures": (0.5, 1.0),
         "no_speech_threshold": 2.0},
        model_cache_dir=str(audio_dir), device="cpu")
    assert rows and all(0.0 <= r["payload"]["confidence"] <= 1.0 for r in rows)


def test_random_weights_emit_nothing_in_both(audio_dir):
    cfg = {"model": "tiny", "compute_dtype": "float32", "max_tokens": 8,
           "batch_size": 2}
    wav = str(audio_dir / "clip.wav")
    assert jax_transcribe.run_transcription(wav, cfg) == []
    assert InferenceEngine(device="cpu").run_task("transcription", wav, cfg) == []


def test_no_audio_gives_no_rows(tmp_path):
    video = tmp_path / "v.mp4"
    video.write_bytes(b"not a video")
    assert transcribe.run_transcription(str(video), {}, device="cpu") == []
    assert jax_transcribe.run_transcription(str(video), {}) == []


@pytest.mark.parametrize("config,needle", [
    ({"compute_dtype": "float16"}, "float16"),
    ({"tensor_parallel": 2}, "tensor_parallel"),
])
def test_unported_options_raise(audio_dir, config, needle):
    with pytest.raises(ModelNotAvailable, match=needle):
        transcribe.run_transcription(str(audio_dir / "clip.wav"), config,
                                     device="cpu")


def test_model_vad_checkpoint_runs_as_jax(audio_dir, pretrained, tmp_path):
    """A Silero checkpoint in the cache gates the windows through the model
    VAD in both packages (tests/test_torch_vad.py holds the VAD itself; its
    shifted head passes the loaders' behavioural check)."""
    import test_torch_vad

    from eioku_tpu.models.vad.weights import export_silero_state_dict

    torch.save(export_silero_state_dict(test_torch_vad._shifted()),
               tmp_path / "silero_vad.ckpt")
    (tmp_path / "vocab.json").write_text((audio_dir / "vocab.json").read_text())
    cfg = {"model": "tiny", "compute_dtype": "float32", "language": "en",
           "temperatures": [], "no_speech_threshold": 2.0, "max_tokens": 10,
           "batch_size": 2, "beam_size": 2}
    wav, cache = str(audio_dir / "clip.wav"), str(tmp_path)
    x = audio_io.load_wav(wav)
    model_vad = audio_io.compute_vad(x, model_cache_dir=cache, device="cpu")
    np.testing.assert_array_equal(model_vad,
                                  jax_audio_io.compute_vad(x, model_cache_dir=cache))
    assert not np.array_equal(model_vad, audio_io.energy_vad(x))
    want = jax_transcribe.run_transcription(wav, cfg, model_cache_dir=cache)
    got = InferenceEngine(model_cache_dir=cache, device="cpu").run_task(
        "transcription", wav, cfg)
    rows_w, conf_w = _split_confidence(want)
    rows_g, conf_g = _split_confidence(got)
    assert rows_g == rows_w and len(got) > 0
    np.testing.assert_allclose(conf_g, conf_w, rtol=0, atol=1e-4)
    # without the model VAD: the energy VAD, as the JAX package falls back to
    assert np.array_equal(audio_io.compute_vad(x, model_cache_dir=str(audio_dir)),
                          jax_audio_io.compute_vad(x, model_cache_dir=str(audio_dir)))


def test_audio_io_matches_jax(audio_dir, tmp_path):
    wav = str(audio_dir / "clip.wav")
    x = audio_io.load_audio(wav)
    np.testing.assert_array_equal(x, jax_audio_io.load_audio(wav))
    assert np.array_equal(audio_io.energy_vad(x), jax_audio_io.energy_vad(x))
    got = audio_io.split_windows(x, window_s=30.0)
    want = jax_audio_io.split_windows(x, window_s=30.0)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 60000]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # stereo 8 kHz: channel mean, then resampled to 16 kHz
    st = np.random.default_rng(1).uniform(-0.5, 0.5, 8000 * 2)
    _write_wav(tmp_path / "st.wav", st, sr=8000, channels=2)
    np.testing.assert_array_equal(audio_io.load_wav(str(tmp_path / "st.wav")),
                                  jax_audio_io.load_wav(str(tmp_path / "st.wav")))
    # a sidecar wav beside a video
    (tmp_path / "movie.mp4").write_bytes(b"")
    _write_wav(tmp_path / "movie.wav", st[:8000])
    assert audio_io.find_audio_for_video(str(tmp_path / "movie.mp4")) == \
        jax_audio_io.find_audio_for_video(str(tmp_path / "movie.mp4")) == \
        str(tmp_path / "movie.wav")


def test_helpers_match_jax():
    assert transcribe.compression_ratio("ab " * 50) == \
        jax_transcribe.compression_ratio("ab " * 50)
    for args in ((-2.0, 0.9, "x", -1.0, 0.6, 2.4), (-2.0, 0.1, "x", -1.0, 0.6, 2.4),
                 (-0.1, 0.1, "ab " * 50, -1.0, 0.6, 2.4)):
        assert transcribe.needs_temperature_fallback(*args) == \
            jax_transcribe.needs_temperature_fallback(*args)
    for name in ("whisper-tiny", "large-v3", "nonsense"):
        assert transcribe._normalize_variant(name) == \
            jax_transcribe._normalize_variant(name)
