"""Tensor- and pipeline-parallel Whisper in the port (models/whisper/model.py
`shard_whisper`, `whisper_encode_tp`, `whisper_encode_pp`,
`decoder_step_tp`; decoding.py `whisper_decode_windows_tp`) against the
JAX package, on the CPU at fp32.

One seeded tiny tree (`init_whisper_params(seed=0)`) goes to both packages
(the port's through `from_jax_params`), and the same numpy mel to both
encoders. The JAX functions run on conftest's 8 virtual host devices, on
the (data 4, model 2) mesh of tests/test_parallel.py; the port's mesh is
the same grid over `local_devices` replaced by `[cpu] * 8` (one process,
backend a of parallel/collectives.py). Tiny has 6 heads: tp 2 gives 3 a
shard, tp 4 must raise. Tolerances are the JAX suite's: encoders rtol 1e-4,
atol 1e-5; decodes token-equal, avg logprob and no-speech probability
within rtol 1e-4, atol 1e-5 (the partial sums of each residual branch and
of the logits add in another order than one device's products).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.models.whisper import decoding as jax_decoding
from eioku_tpu.models.whisper import model as jax_model
from eioku_tpu.models.whisper.mel import log_mel_spectrogram as jax_mel
from eioku_tpu.models.whisper.tokenizer import WhisperTokens
from eioku_tpu.parallel import mesh as jax_mesh
from eioku_tpu_torch.models.whisper import weights
from eioku_tpu_torch.models.whisper.decoding import (
    build_suppress_masks,
    whisper_decode_windows,
    whisper_decode_windows_tp,
)
from eioku_tpu_torch.models.whisper.model import (
    WhisperConfig,
    decoder_step,
    decoder_step_tp,
    precompute_cross_kv,
    precompute_cross_kv_tp,
    shard_whisper,
    whisper_encode,
    whisper_encode_pp,
    whisper_encode_tp,
)
from eioku_tpu_torch.parallel import mesh

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture()
def cpu8(monkeypatch):
    monkeypatch.setattr(mesh, "local_devices", lambda device=None: [CPU] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    return jax_mesh.make_mesh(8, model_parallel=2)


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_model.WhisperConfig("tiny")
    params = jax_model.init_whisper_params(cfg, seed=0)
    model = weights.from_jax_params(jax.tree.map(np.asarray, params), WhisperConfig("tiny"))
    return params, cfg, model.eval()


def _mel(batch: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    wav = jnp.asarray(rng.standard_normal((batch, 4 * 16000)) * 0.1, jnp.float32)
    return np.array(jax_mel(wav, n_mels=80)[:, :, :200])


def _close(got: torch.Tensor, want, label: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=label)


def test_shards_follow_the_jax_specs(tiny, cpu8, jmesh8, monkeypatch):
    """Each entry's shard of every parameter is the JAX package's shard
    (`shard_whisper_specs`) on the device at the same mesh position, carried
    to the port's names and layouts by `from_jax_params`."""
    params, _, model = tiny
    specs = jax_model.shard_whisper_specs(params)
    placed = jax.device_put(params, jax.tree.map(
        lambda s: jax.sharding.NamedSharding(jmesh8, s), specs))
    shards = shard_whisper(model, mesh.make_mesh(8, model_parallel=2))
    assert shards.tp == 2 and len(shards.lines) == 4
    monkeypatch.setattr(weights, "load_state_dict", lambda m, sd: sd)
    for i, row in enumerate(jmesh8.devices):
        for j, dev in enumerate(row):
            shard_tree = jax.tree.map(
                lambda leaf: next(np.asarray(s.data) for s in leaf.addressable_shards
                                  if s.device == dev), placed)
            want = weights.from_jax_params(shard_tree, WhisperConfig("tiny"))
            got = dict(shards.lines[i].shards[j].named_parameters())
            assert set(got) == set(want)
            for name, w in want.items():
                np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    q = shards.lines[0].shards[1].encoder.blocks[0].attn.query.weight
    assert q.shape == (192, 384)  # column split of [384, 384]
    # on the model's own device a shard is a view of the model's weights
    full = model.encoder.blocks[0].attn.query.weight
    assert q.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()


@pytest.mark.parametrize("n,batch", [(8, 4), (2, 2)])
def test_whisper_encode_tp_matches_jax_and_one_device(tiny, cpu8, jmesh8, n, batch):
    """(8, 4): data 4 x model 2, one window a line, as the JAX test; (2, 2):
    one line of two shards over the whole batch."""
    params, cfg, model = tiny
    mel = _mel(batch)
    want = jax_model.whisper_encode_tp(params, jnp.asarray(mel), cfg,
                                       jax_mesh.make_mesh(n, model_parallel=2))
    got = whisper_encode_tp(model, torch.from_numpy(mel), mesh.make_mesh(n, model_parallel=2))
    assert got.shape == (batch, 100, 384) and got.dtype == torch.float32
    _close(got, want, "port TP vs JAX TP")
    _close(got, whisper_encode(model, torch.from_numpy(mel)).numpy(), "TP vs one device")


def test_whisper_encode_pp_matches_jax_and_one_device(tiny, cpu8, jmesh8):
    """4 encoder layers, 2 a stage; batch 8: 2 a data line, 2 microbatches
    of 1 (the JAX test's case)."""
    params, cfg, model = tiny
    mel = _mel(8)
    want = jax_model.whisper_encode_pp(params, jnp.asarray(mel), cfg, jmesh8, n_micro=2)
    got = whisper_encode_pp(model, torch.from_numpy(mel), mesh.make_mesh(8, model_parallel=2),
                            n_micro=2)
    _close(got, want, "port PP vs JAX PP")
    _close(got, whisper_encode(model, torch.from_numpy(mel)).numpy(), "PP vs one device")


def test_head_divisibility_enforced(tiny, cpu8):
    """6 heads over tp 4: both packages raise ValueError."""
    params, cfg, model = tiny
    mel = np.zeros((4, 80, 200), np.float32)
    with pytest.raises(ValueError, match="divide"):
        jax_model.whisper_encode_tp(params, jnp.asarray(mel), cfg,
                                    jax_mesh.make_mesh(8, model_parallel=4))
    m4 = mesh.make_mesh(8, model_parallel=4)
    with pytest.raises(ValueError, match="divide"):
        whisper_encode_tp(model, torch.from_numpy(mel), m4)
    with pytest.raises(ValueError, match="divide"):
        shard_whisper(model, m4)


def test_decoder_step_tp_matches_decoder_step(tiny, cpu8):
    """One decode step over two shards: the logits and every shard's slice
    of the caches equal one device's."""
    _, cfg, model = tiny
    enc = whisper_encode(model, torch.from_numpy(_mel(2)))
    tk = WhisperTokens(cfg.vocab_size)
    tokens = torch.tensor([tk.sot_sequence("en")] * 2)
    shards = shard_whisper(model, mesh.make_mesh(2, model_parallel=2))
    line = shards.lines[0]
    ck, cv = precompute_cross_kv(model, enc)
    ck_tp, cv_tp = precompute_cross_kv_tp(line, enc)
    sk = torch.zeros((4, 2, 8, 384))
    sv = torch.zeros_like(sk)
    sk_tp = [torch.zeros((4, 2, 8, 192)) for _ in range(2)]
    sv_tp = [torch.zeros((4, 2, 8, 192)) for _ in range(2)]
    for pos in range(3):
        want = decoder_step(model, ck, cv, tokens, sk, sv, pos)
        got = decoder_step_tp(line, ck_tp, cv_tp, tokens, sk_tp, sv_tp, pos)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch.cat(sk_tp, dim=-1).numpy(), sk.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch.cat(cv_tp, dim=-1).numpy(), cv.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("beam", [1, 2])
def test_tp_decode_matches_jax_and_one_device(tiny, cpu8, jmesh8, beam):
    """The KV-cached beam loop over two shards: tokens equal to the JAX
    package's TP decode and to the port's one-device decode."""
    params, cfg, model = tiny
    mel = _mel(2)
    enc_j = jax_model.whisper_encode(params, jnp.asarray(mel), cfg)
    tk = WhisperTokens(cfg.vocab_size)
    sot = np.asarray([tk.sot_sequence("en")] * 2, np.int32)
    want = jax_decoding.whisper_decode_windows_tp(
        params, enc_j, jnp.asarray(sot), *jax_decoding.build_suppress_masks(tk, timestamps=True),
        cfg, jmesh8, max_len=16, beam_size=beam)
    enc = whisper_encode(model, torch.from_numpy(mel))
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    one = whisper_decode_windows(model, enc, torch.from_numpy(sot), sup_a, sup_b,
                                 max_len=16, beam_size=beam)
    got = whisper_decode_windows_tp(model, enc, torch.from_numpy(sot), sup_a, sup_b,
                                    mesh=mesh.make_mesh(8, model_parallel=2),
                                    max_len=16, beam_size=beam)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
    for k in (1, 2):
        _close(got[k], want[k], f"output {k} vs JAX")
        _close(got[k], one[k].numpy(), f"output {k} vs one device")


def test_tp_decode_samples_as_one_device(tiny, cpu8):
    """Sampling chains (the temperature ladder) over reused shards: the same
    generator seed gives the same draws as one device."""
    _, cfg, model = tiny
    enc = whisper_encode(model, torch.from_numpy(_mel(2)))
    tk = WhisperTokens(cfg.vocab_size)
    sot = torch.tensor([tk.sot_sequence("en")] * 2)
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    shards = shard_whisper(model, mesh.make_mesh(2, model_parallel=2))
    for temp in (0.2, 1.0):
        kw = dict(max_len=12, beam_size=2, sample=True, temperature=temp)
        one = whisper_decode_windows(model, enc, sot, sup_a, sup_b,
                                     generator=torch.Generator().manual_seed(7), **kw)
        got = whisper_decode_windows_tp(shards, enc, sot, sup_a, sup_b,
                                        generator=torch.Generator().manual_seed(7), **kw)
        np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
        _close(got[1], one[1].numpy(), f"avg logprob at T={temp}")
