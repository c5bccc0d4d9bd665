"""The port's Whisper modules against the JAX package's, on the CPU at fp32.

Weights come across through `from_jax_params` from the JAX package's
`init_whisper_params(WhisperConfig("tiny"), seed=0)`; inputs are made with
numpy from fixed seeds. Tolerances, and why:
- K3's plain version: 2e-5 absolute, the JAX kernel tests' own tolerance
  (both sum fp32 products in different orders);
- mel: 2e-5 absolute on values of order 1 (fp32 matmuls against the same
  DFT bases, summed in other orders, then log10);
- encoder states: 5e-5 absolute (four layers of fp32 matmuls on values up
  to ~4, summation order only);
- logits: 1e-5 absolute (values of order 1e-2);
- decoded tokens: equal; avg_logprob and no_speech_prob within 1e-4
  (fp32 logsumexp over 51865 logits).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.models import layers as jax_layers
from eioku_tpu.models.whisper import decoding as jax_decoding
from eioku_tpu.models.whisper import mel as jax_mel
from eioku_tpu.models.whisper import model as jax_model
from eioku_tpu.models.whisper.tokenizer import WhisperTokens as JaxTokens
from eioku_tpu.models.whisper.weights import (
    load_whisper_checkpoint as jax_load_checkpoint,
)
from eioku_tpu.ops.flash_attention import _reference_attention
from eioku_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from eioku_tpu_torch.models import layers
from eioku_tpu_torch.models.whisper import decoding, mel, model, weights
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTextDecoder, WhisperTokens
from eioku_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

JAX_TINY = jax_model.WhisperConfig("tiny")
TINY = model.WhisperConfig("tiny")


@pytest.fixture(scope="module")
def jax_params():
    return jax_model.init_whisper_params(JAX_TINY, seed=0)


@pytest.fixture(scope="module")
def port_model(jax_params):
    return weights.from_jax_params(jax.tree.map(np.asarray, jax_params), TINY)


@pytest.fixture(scope="module")
def mel_batch():
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 30 * 16000)) * 0.1).astype(np.float32)
    return np.array(jax_mel.log_mel_spectrogram(jnp.asarray(wav), n_mels=80))


@pytest.fixture(scope="module")
def enc_pair(jax_params, port_model, mel_batch):
    want = np.array(jax_model.whisper_encode(jax_params, jnp.asarray(mel_batch),
                                             JAX_TINY))
    got = model.whisper_encode(port_model, torch.from_numpy(mel_batch)).numpy()
    return want, got


# -- K3's plain version -------------------------------------------------------------


def _qkv(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, s, d)) * 0.3).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("s,d,causal,lengths", [
    (256, 64, True, None),
    (256, 64, False, [256, 130]),
    (200, 64, False, None),
    (200, 32, True, None),
    (130, 32, False, [0, 77]),  # a batch row with no valid key
])
def test_flash_plain_matches_jax_reference_and_kernel(s, d, causal, lengths):
    q, k, v = _qkv(2, 2, s, d, seed=s + d)
    lens = np.asarray(lengths if lengths else [s, s], np.int32)
    ref = np.asarray(_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(lens),
                                          causal, d ** -0.5))
    pallas = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(lens) if lengths else None, causal=causal,
        force_pallas=True))  # the Pallas kernel in interpret mode
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          lengths=torch.from_numpy(lens) if lengths else None,
                          causal=causal).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-5)
    if lengths and lengths[0] == 0:
        assert not got[0].any()  # zeros, not NaN


def test_flash_plain_reads_strided_heads_and_refuses_other_head_dims():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 3, 40, 64, seed=1))
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    torch.testing.assert_close(flash_attention(*strided), flash_attention(q, k, v))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48], k[..., :48], v[..., :48])
    assert flash_attention_plain(q, k, v, scale=0.1).shape == q.shape


def test_flash_kernel_view_keeps_strided_heads_and_copies_what_tma_refuses():
    from eioku_tpu_torch.ops.flash_attention import _kernel_view

    bshd = torch.zeros((2, 10, 3, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert _kernel_view(bshd) is bshd  # the encoder's layout goes in as is
    expanded = torch.zeros((1, 1, 10, 64), dtype=torch.bfloat16).expand(2, 3, 10, 64)
    odd_rows = torch.zeros((2, 3, 10, 68), dtype=torch.bfloat16)[..., :64]
    for t in (expanded, odd_rows):  # a 0 stride; rows not whole 16 bytes apart
        view = _kernel_view(t)
        assert view.is_contiguous() and torch.equal(view, t)


# -- layers, tokenizer, mel -----------------------------------------------------------


def test_layers_round_like_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    gamma, beta = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    w, b = rng.standard_normal((48, 24)).astype(np.float32), \
        rng.standard_normal(24).astype(np.float32)
    want_ln = jax_layers.layernorm(jnp.asarray(x), {"gamma": gamma, "beta": beta},
                                   eps=1e-5)
    got_ln = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                               torch.from_numpy(beta), eps=1e-5)
    np.testing.assert_allclose(got_ln.numpy(), np.asarray(want_ln), atol=1e-5)
    lin = layers.Linear(48, 24)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
        got_lin = lin(torch.from_numpy(x)).numpy()
    want_lin = jax_layers.linear(jnp.asarray(x), {"w": w, "b": b})
    np.testing.assert_allclose(got_lin, np.asarray(want_lin), atol=1e-4)
    np.testing.assert_allclose(layers.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)


def test_tokens_layout_matches_jax():
    for vocab in (51865, 51866):
        t, j = WhisperTokens(vocab), JaxTokens(vocab)
        assert vars(t) == vars(j)
        assert t.sot_sequence("de", timestamps=True, task="translate") == \
            j.sot_sequence("de", timestamps=True, task="translate")
    dec = WhisperTextDecoder(None, WhisperTokens(51865))
    assert dec.decode([5, 50257, 7]) == "<5> <7>"


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    rng = np.random.default_rng(n_mels)
    wav = (rng.standard_normal((2, 30 * 16000)) * 0.2).astype(np.float32)
    wav[1, :16000] = 0.0  # a silent second: the clamp to max - 8 acts
    want = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wav), n_mels=n_mels))
    got = mel.log_mel_spectrogram(torch.from_numpy(wav), n_mels=n_mels).numpy()
    assert got.shape == (2, n_mels, 3000)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# -- model ----------------------------------------------------------------------------


def test_encoder_states_match_jax(enc_pair):
    want, got = enc_pair
    assert got.shape == (2, 1500, 384)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_decode_full_and_language_detection_match_jax(jax_params, port_model,
                                                      enc_pair):
    enc = enc_pair[0]
    toks = np.random.default_rng(5).integers(0, TINY.vocab_size, (2, 7))
    want = np.asarray(jax_model.whisper_decode_full(
        jax_params, jnp.asarray(toks, jnp.int32), jnp.asarray(enc), JAX_TINY))
    got = model.whisper_decode_full(port_model, torch.from_numpy(toks),
                                    torch.from_numpy(enc)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    lang_j = np.asarray(jax_model.whisper_detect_language(
        jax_params, jnp.asarray(enc), JAX_TINY))
    lang_t = model.whisper_detect_language(port_model, torch.from_numpy(enc))
    assert lang_t.tolist() == lang_j.tolist()


@pytest.mark.parametrize("grouped", [False, True])
def test_decoder_step_matches_jax(jax_params, port_model, enc_pair, grouped):
    # grouped: 2 beams per window share one cross-KV row
    enc = enc_pair[0]
    g = 2 if grouped else 1
    rows, max_len, n_pos = 2 * g, 8, 4
    toks = np.random.default_rng(6).integers(0, TINY.vocab_size, (rows, max_len))
    ck_j, cv_j = jax_model.precompute_cross_kv(jax_params, jnp.asarray(enc))
    ck_t, cv_t = model.precompute_cross_kv(port_model, torch.from_numpy(enc))
    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), rtol=0, atol=5e-5)
    sk_j = jnp.zeros((TINY.n_dec_layers, rows, max_len, TINY.dim))
    sv_j = sk_j
    sk_t = torch.zeros((TINY.n_dec_layers, rows, max_len, TINY.dim))
    sv_t = torch.zeros_like(sk_t)
    for pos in range(n_pos):
        lj, sk_j, sv_j = jax_model.decoder_step(
            jax_params, ck_j, cv_j, jnp.asarray(toks, jnp.int32), sk_j, sv_j,
            pos, JAX_TINY)
        lt = model.decoder_step(port_model, ck_t, cv_t, torch.from_numpy(toks),
                                sk_t, sv_t, pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sk_t.numpy(), np.asarray(sk_j), rtol=0, atol=5e-5)


@pytest.mark.parametrize("beam,timestamps", [(1, False), (1, True), (3, False),
                                             (3, True)])
def test_decode_windows_match_jax(jax_params, port_model, enc_pair, beam,
                                  timestamps):
    enc = enc_pair[0]
    tk = WhisperTokens(TINY.vocab_size)
    sot = tk.sot_sequence("en", timestamps=timestamps)
    init = np.asarray([sot] * 2, np.int32)
    sa_j, sb_j = jax_decoding.build_suppress_masks(JaxTokens(TINY.vocab_size),
                                                   timestamps)
    sa_t, sb_t = decoding.build_suppress_masks(tk, timestamps)
    assert np.array_equal(sa_t.numpy(), np.asarray(sa_j))
    assert np.array_equal(sb_t.numpy(), np.asarray(sb_j))
    want = jax_decoding.whisper_decode_windows(
        jax_params, jnp.asarray(enc), jnp.asarray(init), sa_j, sb_j, JAX_TINY,
        max_len=20, beam_size=beam, timestamps=timestamps)
    got = decoding.whisper_decode_windows(
        port_model, torch.from_numpy(enc), torch.from_numpy(init), sa_t, sb_t,
        max_len=20, beam_size=beam, timestamps=timestamps)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-4)
    if timestamps:  # the first generated token is a timestamp
        assert all(r[len(sot)] >= tk.timestamp_begin for r in got[0].tolist())


def test_sampling_decode_is_deterministic_per_generator(port_model, enc_pair):
    # torch.Generator and jax.random give different draws: the sampled path
    # is checked for determinism and shape, not against JAX
    enc = torch.from_numpy(enc_pair[0])
    tk = WhisperTokens(TINY.vocab_size)
    init = torch.tensor([tk.sot_sequence("en")] * 2)
    sa, sb = decoding.build_suppress_masks(tk, timestamps=False)
    runs = [decoding.whisper_decode_windows(
        port_model, enc, init, sa, sb, max_len=12, beam_size=2, timestamps=False,
        sample=True, temperature=0.8,
        generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][0].shape == (2, 12)
    with pytest.raises(ValueError, match="generator"):
        decoding.whisper_decode_windows(port_model, enc, init, sa, sb,
                                        max_len=12, sample=True)


# -- checkpoints -----------------------------------------------------------------------


def _hf_name(key: str) -> str:
    """OpenAI -> HF naming, the inverse of weights._openai_name."""
    top = {v: k for k, v in weights._HF_TOP.items()}
    if key in top:
        return "model." + top[key]
    if key.startswith("encoder.conv"):
        return "model." + key
    side, _, idx, rest = key.split(".", 3)
    for hf, oa in weights._HF_LAYER:
        if rest.startswith(oa + "."):
            rest = hf + rest[len(oa):]
            break
    return f"model.{side}.layers.{idx}.{rest}"


@pytest.mark.parametrize("fmt", ["npz-openai", "pt-hf"])
def test_checkpoint_loads_like_jax(port_model, mel_batch, tmp_path, fmt):
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    if fmt == "npz-openai":
        path = str(tmp_path / "whisper-tiny.npz")
        np.savez(path, **sd)
    else:
        path = str(tmp_path / "whisper-tiny.pt")
        torch.save({_hf_name(k): torch.from_numpy(v) for k, v in sd.items()}, path)
    jp = jax_load_checkpoint(path, JAX_TINY)
    mp = weights.load_whisper_checkpoint(path, TINY)
    want = np.asarray(jax_model.whisper_encode(jp, jnp.asarray(mel_batch[:1]),
                                               JAX_TINY))
    got = model.whisper_encode(mp, torch.from_numpy(mel_batch[:1])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    with pytest.raises(KeyError, match="lacks"):
        weights.load_state_dict(model.init_whisper(TINY, torch.Generator()),
                                {"encoder.conv1.weight": sd["encoder.conv1.weight"]})


def test_random_init_follows_the_jax_scheme():
    m = model.init_whisper(TINY, torch.Generator().manual_seed(0)).requires_grad_(False)
    blk = m.encoder.blocks[0]
    bound = (6.0 / (384 + 384)) ** 0.5
    assert float(blk.attn.query.weight.abs().max()) <= bound
    assert float(blk.attn.query.weight.abs().max()) > 0.9 * bound
    assert blk.attn.key.bias is None and not blk.attn.query.bias.any()
    assert float(m.decoder.token_embedding.weight.abs().max()) <= \
        0.02 * (6.0 / (51865 + 384)) ** 0.5
    assert torch.equal(m.encoder.ln_post.weight, torch.ones(384))
