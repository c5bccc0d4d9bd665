"""The port's text models against the JAX package's (CPU, fp32): the
WordPiece tokenizer, MiniLM-L6 on both attention routes (plain below S = 512,
K3's plain version from S = 512) and the cross-encoder, carried across with
`from_jax_params` and loaded from the checkpoint files both packages read.

Inputs are made from seeded numpy draws. Tolerances: embeddings and logits
within 1e-5 absolute (fp32, the same weights; the two packages sum in other
orders); token ids equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.models.checkpoint import save_params
from eioku_tpu.models.embed import cross_encoder as jce
from eioku_tpu.models.embed import minilm as jml
from eioku_tpu.models.embed.tokenizer import WordPieceTokenizer as JaxTokenizer
from eioku_tpu_torch.models.embed import cross_encoder as pce
from eioku_tpu_torch.models.embed import minilm as pml
from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer
from eioku_tpu_torch.models.layers import split_heads
from eioku_tpu_torch.ops.flash_attention import _kernel_view

TOL = 1e-5
SMALL = dict(vocab_size=1000, dim=128, n_layers=2, n_heads=4, ffn_dim=256)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "un", "##happy",
         "dog", "##s", "cafe", "deja", "-", "vu", ",", "!", ".", "the", "light",
         "##house", "keep", "##er", "naive", "unicode", "word", "東", "京", "“", "”"]
TEXTS = {
    "ascii": "Hello, World! The unhappy dogs keep the lighthouse.",
    "non_ascii": "Café déjà-vu — naïve Ünïcödé “dogs” 東京 world",
    "over_long": " ".join(["word", "lighthouse", "unhappy"] * 120),
    "empty": "",
}


def _tokenizers(vocab: bool, matcher: str, max_len: int = 64):
    v = {t: i for i, t in enumerate(VOCAB)} if vocab else None
    pair = (JaxTokenizer(vocab=v, max_len=max_len),
            WordPieceTokenizer(vocab=v, max_len=max_len))
    if vocab and matcher == "native":
        assert all(t._native is not None for t in pair), "native matcher did not build"
    if matcher == "python":
        for t in pair:
            t._native = None
    return pair


@pytest.mark.parametrize("vocab,matcher", [(True, "native"), (True, "python"),
                                           (False, "python")])
@pytest.mark.parametrize("text", sorted(TEXTS))
def test_tokenizer_encodes_as_jax(vocab, matcher, text):
    jt, pt = _tokenizers(vocab, matcher)
    assert pt.encode(TEXTS[text]) == jt.encode(TEXTS[text])
    assert pt.encode_pair(TEXTS["ascii"], TEXTS[text]) == \
        jt.encode_pair(TEXTS["ascii"], TEXTS[text])
    for got, want in zip(pt.encode_pairs(TEXTS[text], list(TEXTS.values())),
                         jt.encode_pairs(TEXTS[text], list(TEXTS.values()))):
        np.testing.assert_array_equal(got, want)


def test_tokenizer_reads_the_cache_vocab_as_jax(tmp_path):
    (tmp_path / "minilm-l6").mkdir()
    (tmp_path / "minilm-l6" / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    jt = JaxTokenizer.from_cache_dir(str(tmp_path), max_len=32)
    pt = WordPieceTokenizer.from_cache_dir(str(tmp_path), max_len=32)
    assert pt.vocab == jt.vocab and pt.vocab is not None
    for got, want in zip(pt.encode_batch(list(TEXTS.values())),
                         jt.encode_batch(list(TEXTS.values()))):
        np.testing.assert_array_equal(got, want)


# -- MiniLM ---------------------------------------------------------------------------


def _jax_tree(params):
    return jax.tree.map(np.asarray, params)


def _pair(cfg_kwargs: dict, seed: int = 0):
    """The JAX params and config, and the port's model carrying them."""
    jcfg = jml.MiniLMConfig(**cfg_kwargs)
    params = jml.init_minilm_params(jcfg, seed=seed)
    model = pml.load_state(pml.MiniLM(pml.MiniLMConfig(**cfg_kwargs)),
                           pml.from_jax_params(_jax_tree(params))).eval()
    return params, jcfg, model


def _ids_mask(b: int, s: int, vocab: int, seed: int):
    """Seeded ids with padded tails: row 0 full, the others cut short."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row in range(1, b):
        mask[row, int(rng.integers(1, s)):] = 0
    ids[mask == 0] = 0
    return ids, mask


def _count_flash(monkeypatch) -> list:
    calls, fn = [], pml.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(pml, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("s", [64, 512])
def test_minilm_matches_jax(monkeypatch, s):
    params, jcfg, model = _pair(SMALL, seed=1)
    ids, mask = _ids_mask(3, s, SMALL["vocab_size"], seed=s)
    calls = _count_flash(monkeypatch)
    got = pml.minilm_embed(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jml.minilm_embed(params, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the K3 route from S = 512 only: one call per layer
    assert len(calls) == (SMALL["n_layers"] if s >= 512 else 0)


def test_minilm_full_width_matches_jax():
    params, jcfg, model = _pair({}, seed=2)
    ids, mask = _ids_mask(2, 32, jcfg.vocab_size, seed=7)
    got = pml.minilm_embed(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jml.minilm_embed(params, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    assert got.shape == (2, 384)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_minilm_heads_reach_k3_without_a_copy():
    # the S >= 512 route hands K3 [B, H, S, 32] views of the [B, S, d]
    # projections; in bf16 their strides (S*d, 32, d, 1) suit the TMA, so
    # the wrapper takes them as they are
    x = torch.zeros((8, 512, 384), dtype=torch.bfloat16)
    view = split_heads(x, 12)
    assert view.shape == (8, 12, 512, 32)
    assert _kernel_view(view) is view


def test_minilm_random_init_scheme():
    model = pml.init_minilm(pml.MiniLMConfig(**SMALL), torch.Generator().manual_seed(0))
    lin = model.encoder.layer[0].intermediate.dense
    bound = (6.0 / (lin.in_features + lin.out_features)) ** 0.5
    assert float(lin.weight.abs().max()) <= bound and float(lin.bias.abs().max()) == 0.0
    ln = model.encoder.layer[1].output.LayerNorm
    assert torch.equal(ln.weight, torch.ones_like(ln.weight)) and ln.eps == 1e-12
    emb = model.embeddings.word_embeddings.weight
    assert float(emb.abs().max()) <= 0.05 * (6.0 / (1000 + 128)) ** 0.5


def _hf_state_dict(model: torch.nn.Module, prefix: str) -> dict:
    return {prefix + k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name,prefix", [
    ("minilm-l6/pytorch_model.bin", "0.auto_model."),
    ("pytorch_model.bin", ""),
    ("minilm-l6/weights.npz", "bert."),
    ("minilm.npz", ""),
    ("minilm-l6/native.npz", None),
    ("minilm-native.npz", None),
])
def test_load_minilm_reads_what_jax_reads(tmp_path, name, prefix):
    params, jcfg, model = _pair(SMALL, seed=4)
    path = tmp_path / name
    path.parent.mkdir(exist_ok=True)
    if prefix is None:  # the JAX package's own native writer
        save_params(params, str(path))
    elif name.endswith(".bin"):
        torch.save(_hf_state_dict(model, prefix), path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in _hf_state_dict(model, prefix).items()})
    jparams, _, jpre = jml.load_minilm(str(tmp_path), jcfg, seed=9)
    loaded, cfg, pre = pml.load_minilm(str(tmp_path), pml.MiniLMConfig(**SMALL), seed=9)
    assert pre and jpre and cfg == pml.MiniLMConfig(**SMALL)
    ids, mask = _ids_mask(2, 48, SMALL["vocab_size"], seed=5)
    got = pml.minilm_embed(loaded, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jml.minilm_embed(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_load_minilm_without_a_checkpoint_is_random(tmp_path):
    model, _, pretrained = pml.load_minilm(str(tmp_path), pml.MiniLMConfig(**SMALL))
    again, _, _ = pml.load_minilm(None, pml.MiniLMConfig(**SMALL))
    assert not pretrained
    assert torch.equal(model.embeddings.word_embeddings.weight,
                       again.embeddings.word_embeddings.weight)


def test_load_minilm_refuses_a_checkpoint_of_another_shape(tmp_path):
    params, _, _ = _pair(dict(SMALL, dim=64, n_heads=2), seed=0)
    save_params(params, str(tmp_path / "minilm-native.npz"))
    with pytest.raises(ValueError, match="shape mismatch"):
        pml.load_minilm(str(tmp_path), pml.MiniLMConfig(**SMALL))


# -- cross-encoder ----------------------------------------------------------------------


def _ce_pair(seed: int = 0):
    jcfg = jce.CrossEncoderConfig(**SMALL)
    params = jce.init_cross_encoder_params(jcfg, seed=seed)
    model = pml.load_state(pce.CrossEncoder(pce.CrossEncoderConfig(**SMALL)),
                           pce.from_jax_params(_jax_tree(params))).eval()
    return params, jcfg, model


def _pair_inputs(b: int, s: int, seed: int):
    ids, mask = _ids_mask(b, s, SMALL["vocab_size"], seed)
    types = np.zeros_like(ids)
    types[:, s // 3:] = 1
    types[mask == 0] = 0
    return ids, types, mask


def _ce_scores(model, params, jcfg, ids, types, mask):
    got = pce.cross_encoder_score(model, *(torch.from_numpy(a) for a in
                                           (ids, types, mask))).numpy()
    want = np.asarray(jce.cross_encoder_score(
        params, jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask), jcfg))
    return got, want


@pytest.mark.parametrize("s", [64, 512])
def test_cross_encoder_matches_jax(s):
    params, jcfg, model = _ce_pair(seed=3)
    got, want = _ce_scores(model, params, jcfg, *_pair_inputs(4, s, seed=s))
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["msmarco-minilm-l6/pytorch_model.bin",
                                  "cross-encoder/pytorch_model.bin",
                                  "msmarco-minilm-l6/weights.npz"])
def test_load_cross_encoder_reads_what_jax_reads(tmp_path, name):
    _, jcfg, model = _ce_pair(seed=6)
    sd = {("" if k.startswith("classifier") else "bert.") + k: v.clone()
          for k, v in model.state_dict().items()}
    path = tmp_path / name
    path.parent.mkdir(exist_ok=True)
    if name.endswith(".bin"):
        torch.save(sd, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    jparams, _, jpre = jce.load_cross_encoder(str(tmp_path), jcfg, seed=1)
    loaded, _, pre = pce.load_cross_encoder(str(tmp_path), pce.CrossEncoderConfig(**SMALL),
                                            seed=1)
    assert pre and jpre
    got, want = _ce_scores(loaded, jparams, jcfg, *_pair_inputs(3, 40, seed=2))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
