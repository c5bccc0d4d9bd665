"""The port's int8 linears (ops/quant.py, QuantLinear) against the JAX
package's ops/quant.py, on the CPU.

- Quantized weights: `w_q` and `w_s` bit-equal (the same numpy arithmetic).
- `linear_q`: the quantized activations and int32 accumulators equal, the
  outputs within 1e-6 of their largest |value| (one fp32 dequantization,
  both sides).
- Models at fp32 activations (bf16 on the CPU is not bit-comparable,
  ROADMAP Queue 3 hazard k): the tiny Whisper int8 decoder step and the
  MiniLM-L6 int8 embedder within 1e-5, the int8 transcription's rows equal.
  A fp32 difference of one ulp can move an activation across a .5 rounding
  boundary of the int8 grid (ROADMAP Queue 3 hazard r): the MiniLM test
  measures each row's margin to such a boundary before it compares.
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
from eioku_tpu.models.embed import minilm as jax_minilm
from eioku_tpu.models.whisper import model as jax_model
from eioku_tpu.ops import quant as jax_quant
from eioku_tpu_torch.ml import transcribe
from eioku_tpu_torch.ml.engine import InferenceEngine
from eioku_tpu_torch.models import layers
from eioku_tpu_torch.models.embed import minilm
from eioku_tpu_torch.models.whisper import model
from eioku_tpu_torch.models.whisper.weights import from_jax_params
from eioku_tpu_torch.ops import quant
from test_torch_ocr import single_torch_thread

TINY = model.WhisperConfig("tiny")
JAX_TINY = jax_model.WhisperConfig("tiny")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread: under the suite's parallel workers the
    per-step parallel regions of small ops (decode steps, the LSTM) wait on
    descheduled threads."""
    with single_torch_thread():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(384, 1536), (1536, 384), (40, 24)])
def test_quantized_weights_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero output column keeps a finite scale
    want = jax_quant.quantize_linear({"w": jnp.asarray(w), "b": jnp.zeros(shape[1])})
    w_q, w_s = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert w_q.dtype == np.int8 and w_s.dtype == np.float32
    np.testing.assert_array_equal(w_q.T, np.asarray(want["w_q"]))
    np.testing.assert_array_equal(w_s, np.asarray(want["w_s"]))


@pytest.mark.parametrize("rows", [1, 7, 40])
def test_linear_q_matches_jax(rows):
    rng = np.random.default_rng(rows)
    w = rng.standard_normal((384, 1540)).astype(np.float32)  # N not a multiple of 8
    b = rng.standard_normal(1540).astype(np.float32)
    x = rng.standard_normal((rows, 3, 384)).astype(np.float32)
    jp = {**jax_quant.quantize_linear({"w": jnp.asarray(w)}), "b": jnp.asarray(b)}
    w_q, w_s = quant.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    xq, sx = quant.quant_act(torch.from_numpy(x))
    jxq, jsx = jax_quant._quant_act(jnp.asarray(x), axes=-1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    acc = quant.int_mm(xq.reshape(-1, 384), torch.from_numpy(w_q))
    want_acc = np.asarray(jnp.dot(jxq, jp["w_q"], preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(acc.numpy(), want_acc.reshape(-1, 1540))
    got = quant.linear_q(torch.from_numpy(x), torch.from_numpy(w_q),
                         torch.from_numpy(w_s), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_quant.linear_q(jnp.asarray(x), jp))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_quantize_linears_walks_the_module():
    tiny = model.init_whisper(TINY, torch.Generator().manual_seed(0))
    layers.quantize_linears(tiny)
    blk = tiny.decoder.blocks[0]
    assert isinstance(blk.attn.query, layers.QuantLinear)
    assert isinstance(blk.mlp[0], layers.QuantLinear) and blk.attn.key.bias is None
    assert blk.attn.query.w_q.dtype == torch.int8
    # convolutions, embeddings and layer norms stay float
    assert tiny.encoder.conv1.weight.dtype == torch.float32
    assert isinstance(blk.attn_ln, torch.nn.LayerNorm)
    assert not any(isinstance(m, torch.nn.Linear) for m in tiny.modules())


def _grid_distance(x: np.ndarray) -> np.ndarray:
    """Per entry, the distance of x / s_x (s_x per row of the last axis) to
    the nearest .5 boundary of the int8 grid, in grid units."""
    s = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / 127.0, 1e-12)
    v = np.abs(x / s)
    return np.abs(v - np.floor(v) - 0.5)


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_model.init_whisper_params(JAX_TINY, seed=0)


def test_whisper_int8_decoder_step_matches_jax(jax_tiny):
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 50, TINY.dim)).astype(np.float32)
    qj = jax_quant.quantize_linears(jax_tiny)
    port = layers.quantize_linears(from_jax_params(_np(jax_tiny), TINY))
    # the same encoder states on both sides: the cross projections' inputs
    # are identical, and so are their int8 activations and outputs
    ck, cv = jax_model.precompute_cross_kv(qj, jnp.asarray(enc))
    pk, pv = model.precompute_cross_kv(port, torch.from_numpy(enc))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(ck))
    max_len = 6
    toks = np.array([[50258, 50259, 50359, 50363, 400, 401]] * 2)
    sk = jnp.zeros((TINY.n_dec_layers, 2, max_len, TINY.dim))
    sv = sk
    psk = torch.zeros((TINY.n_dec_layers, 2, max_len, TINY.dim))
    psv = torch.zeros_like(psk)
    for pos in range(max_len):
        want, sk, sv = jax_model.decoder_step(qj, ck, cv, jnp.asarray(toks), sk, sv,
                                              pos, JAX_TINY)
        got = model.decoder_step(port, pk, pv, torch.from_numpy(toks), psk, psv, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _write_wav(path, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.mark.parametrize("compute_dtype", ["int8", "int8_bfloat16"])
def test_int8_transcription_rows_equal_jax(tmp_path, monkeypatch, jax_tiny,
                                           compute_dtype):
    """Both packages load one seeded tree as the checkpoint, each quantizes
    it (the JAX package's _load_model_int8 over the patched _load_model;
    the port's _load_model quantizes for "int8"), at fp32 activations."""
    _write_wav(tmp_path / "clip.wav", 8)
    (tmp_path / "vocab.json").write_text(json.dumps({f"Ġw{i}": i for i in range(50257)}))
    port_tree = from_jax_params(_np(jax_tiny), TINY)
    seen = []

    def port_load(variant, cache, dtype, *a):
        seen.append(dtype)
        m = copy.deepcopy(port_tree)
        return (layers.quantize_linears(m) if dtype == "int8" else m), TINY, True
    monkeypatch.setattr(jax_transcribe, "_load_model",
                        lambda *a, **kw: (jax_tiny, JAX_TINY, True))
    jax_transcribe._load_model_int8.cache_clear()
    monkeypatch.setattr(transcribe, "_load_model", port_load)
    cfg = {"model": "tiny", "compute_dtype": compute_dtype, "language": "en",
           "temperatures": [], "no_speech_threshold": 2.0, "max_tokens": 12,
           "batch_size": 1, "beam_size": 2}
    wav, cache = str(tmp_path / "clip.wav"), str(tmp_path)
    try:
        want = jax_transcribe.run_transcription(wav, cfg, model_cache_dir=cache)
    finally:
        jax_transcribe._load_model_int8.cache_clear()
    got = InferenceEngine(model_cache_dir=cache, device="cpu").run_task(
        "transcription", wav, cfg)
    assert seen == ["int8"] and len(want) > 0
    conf = lambda rows: [r["payload"].pop("confidence") for r in rows]  # noqa: E731
    np.testing.assert_allclose(conf(got), conf(want), rtol=0, atol=1e-4)
    assert got == want


def test_turbo_defaults_to_int8(tmp_path, monkeypatch):
    """large-v3-turbo with nothing else set loads int8 (its default, as in
    the JAX package) and runs; without a checkpoint the random tiny stands
    in and emits no rows."""
    _write_wav(tmp_path / "clip.wav", 3)
    seen = []
    real = transcribe._load_model

    def spy(variant, cache, dtype, *a):
        seen.append(dtype)
        return real(variant, cache, dtype, *a)
    monkeypatch.setattr(transcribe, "_load_model", spy)
    rows = InferenceEngine(device="cpu").run_task(
        "transcription", str(tmp_path / "clip.wav"),
        {"model": "large-v3-turbo", "max_tokens": 4, "batch_size": 1})
    assert rows == [] and seen == ["int8"]
    quantized, cfg, _ = real("large-v3-turbo", None, "int8", False, torch.device("cpu"))
    assert cfg.variant == "tiny" and cfg.compute_dtype == "bfloat16"
    assert isinstance(quantized.decoder.blocks[0].mlp[2], layers.QuantLinear)


def test_minilm_int8_matches_jax(monkeypatch):
    """Each linear's input is captured in both packages (the JAX one run
    eagerly). A row whose int8 activations are equal in both must agree
    within 1e-5. An activation may round one step apart where the packages'
    fp32 inputs lie on two sides of a .5 boundary (hazard r): a row's first
    such entries must lie within their fp32 difference of the boundary, and
    the row is then held within one step's effect."""
    cfg = jax_minilm.MiniLMConfig(n_layers=2)
    params = jax_minilm.init_minilm_params(cfg, seed=3)
    port = minilm.init_minilm(minilm.MiniLMConfig(n_layers=2),
                              torch.Generator().manual_seed(0))
    minilm.load_state(port, minilm.from_jax_params(_np(params)))
    layers.quantize_linears(port.encoder)
    qparams = {k: jax_quant.quantize_linears(v) if k == "layers" else v
               for k, v in params.items()}
    rng = np.random.default_rng(5)
    ids = rng.integers(1000, 30000, (3, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 15:] = 0
    mask[2, 4:] = 0
    port_in, jax_in = [], []
    hooks = [m.register_forward_pre_hook(lambda _, a: port_in.append(a[0].numpy()))
             for m in port.modules() if isinstance(m, layers.QuantLinear)]
    try:
        got = minilm.minilm_embed(port, torch.from_numpy(ids),
                                  torch.from_numpy(mask)).numpy()
    finally:
        for h in hooks:
            h.remove()
    real = jax_quant.linear_q
    monkeypatch.setattr(jax_quant, "linear_q",
                        lambda x, p: (jax_in.append(np.array(x)), real(x, p))[1])
    with jax.disable_jit():
        want = np.asarray(jax_minilm.minilm_embed(qparams, jnp.asarray(ids),
                                                  jnp.asarray(mask), cfg))
    assert len(port_in) == len(jax_in) == 12
    flipped = np.zeros(len(ids), bool)
    for xp, xj in zip(port_in, jax_in):
        qp, sp = quant.quant_act(torch.from_numpy(xp))
        qj, _ = quant.quant_act(torch.from_numpy(xj))
        diff = (qp != qj).numpy() & (mask[:, :, None] > 0) & ~flipped[:, None, None]
        # a row's first differing entries sit within the inputs' difference
        # of a boundary (what follows in that row is their consequence)
        slack = np.abs(xp - xj) / sp.numpy() + 1e-6
        assert (_grid_distance(xp)[diff] <= slack[diff]).all()
        flipped |= diff.any(axis=(1, 2))
    assert (~flipped).sum() >= 2, flipped
    np.testing.assert_allclose(got[~flipped], want[~flipped], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[flipped], want[flipped], rtol=0, atol=2e-3)
