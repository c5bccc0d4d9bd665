"""The port's model VAD (models/vad) against the JAX package's, on the CPU at
fp32.

Weights: the JAX package's `init_vad_params` trees, carried across with
`from_jax_params` or written as a Silero-named checkpoint. Random weights
put every probability near its bias's sigmoid and fail the loader's
behavioural check, so the activity tests use the seed-0 tree with its
output head scaled and its bias shifted (`HEAD`), which passes that check
in both packages, and assert that every compared probability keeps more
than MARGIN from the 0.5 threshold (ROADMAP Queue 3 hazard s) before they
compare activity. Tolerances: probabilities within 1e-5 (fp32 STFT matmuls,
convolutions and an LSTM summed in other orders); activity, windows and
converted arrays equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.ml import audio_io as jax_audio_io
from eioku_tpu.models.vad import model as jax_vad
from eioku_tpu.models.vad import weights as jax_weights
from eioku_tpu_torch.ml import audio_io
from eioku_tpu_torch.models.vad import model as vad
from eioku_tpu_torch.models.vad import weights
from test_torch_ocr import single_torch_thread

SR = 16000
CFG = jax_vad.VadConfig()
HEAD = (-8.0, -3.0)  # output weight scale and bias of the shifted head
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: under the suite's parallel workers the
    per-step parallel regions of small ops (decode steps, the LSTM) wait on
    descheduled threads."""
    with single_torch_thread():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params) -> vad.SileroVad:
    return weights.vad_from_state_dict(weights.from_jax_params(_np(params)))


def _shifted(seed: int = 0):
    p = jax_vad.init_vad_params(CFG, seed=seed)
    return {**p, "out": {"w": HEAD[0] * p["out"]["w"], "b": jnp.full((1,), HEAD[1])}}


def _clip(seconds: int = 65) -> np.ndarray:
    """A voiced window, 30 s of digital silence, then voice again."""
    rng = np.random.default_rng(0)
    t = np.arange(SR * seconds) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)
    x[30 * SR:60 * SR] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", [(2, SR), (1, 3 * 512 + 100), (7 * 512,)])
def test_vad_probs_match_jax(shape):
    params = jax_vad.init_vad_params(CFG, seed=0)
    audio = (np.random.default_rng(1).standard_normal(shape) * 0.3).astype(np.float32)
    want = np.asarray(jax_vad.vad_probs(params, jnp.asarray(audio), CFG))
    got = vad.vad_probs(_port(params), torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_converter_exporter_and_from_jax_params():
    params = jax_vad.init_vad_params(CFG, seed=1)
    from_jax = weights.from_jax_params(_np(params))
    # the JAX exporter's Silero names -> the port's converter
    converted = weights.convert_silero_state_dict(jax_weights.export_silero_state_dict(params))
    assert converted.keys() == from_jax.keys() == set(vad.SileroVad().state_dict())
    for k in from_jax:
        np.testing.assert_array_equal(converted[k], from_jax[k])
    # the port's exporter -> the JAX package's converter: the same tree
    back = jax_weights.convert_silero_state_dict(
        {k: v.numpy() for k, v in weights.export_silero_state_dict(_port(params)).items()})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seconds", [12, 65])
def test_vad_activity_matches_jax(seconds):
    params = _shifted()
    audio = _clip(seconds)
    # the margin, on the bucket-padded input both packages see
    padded = np.zeros(-(-len(audio) // (30 * SR)) * 30 * SR, np.float32)
    padded[:len(audio)] = audio
    probs = np.asarray(jax_vad.vad_probs(params, jnp.asarray(padded)[None], CFG))[0]
    assert np.abs(probs[:-(-len(audio) // 512)] - 0.5).min() > MARGIN
    want = jax_vad.vad_activity(params, audio, CFG, frame_ms=30)
    got = vad.vad_activity(_port(params), audio, frame_ms=30)
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture()
def ckpt_dir(tmp_path):
    torch.save(jax_weights.export_silero_state_dict(_shifted()),
               tmp_path / "silero_vad.ckpt")
    return tmp_path


def test_split_windows_through_a_cached_checkpoint(ckpt_dir):
    audio = _clip()
    cache = str(ckpt_dir)
    assert weights.load_vad(cache) is not None
    want = jax_audio_io.compute_vad(audio, model_cache_dir=cache)
    got = audio_io.compute_vad(audio, model_cache_dir=cache, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, audio_io.energy_vad(audio))  # the model ran
    got_w = audio_io.split_windows(audio, model_cache_dir=cache, device="cpu")
    want_w = jax_audio_io.split_windows(audio, model_cache_dir=cache)
    assert [s for s, _ in got_w] == [s for s, _ in want_w]
    for (_, a), (_, b) in zip(got_w, want_w):
        np.testing.assert_array_equal(a, b)


def test_unshifted_weights_fail_the_check_in_both(tmp_path):
    """Random weights fail the behavioural check: both packages keep the
    energy VAD."""
    params = jax_vad.init_vad_params(CFG, seed=0)
    torch.save(jax_weights.export_silero_state_dict(params), tmp_path / "silero_vad.ckpt")
    assert weights.load_vad(str(tmp_path)) is None
    assert jax_weights.load_vad(str(tmp_path)) is None
    ok, p_sil, p_tone = weights.sanity_check(_port(params))
    want = jax_weights.sanity_check(params, CFG)
    assert ok == want[0] is False
    np.testing.assert_allclose((p_sil, p_tone), want[1:], rtol=0, atol=1e-6)
    audio = _clip(12)
    np.testing.assert_array_equal(
        audio_io.compute_vad(audio, model_cache_dir=str(tmp_path), device="cpu"),
        audio_io.energy_vad(audio))


def test_model_vad_needs_a_device_on_a_cpu_host(ckpt_dir, monkeypatch):
    """None is CUDA: without a card the model VAD raises, as every entry
    point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        audio_io.compute_vad(_clip(12), model_cache_dir=str(ckpt_dir))
