"""The port's embedder fine-tune (models/checkpoint.py, parallel/train.py,
parallel/finetune.py) against the JAX package's, on the CPU at fp32.

Both packages start from one seeded MiniLM tree at a small width (TINY),
its token embeddings scaled by 100 (hazard l: random weights embed every
text alike, which leaves gradients of ~1e-8 that AdamW's normalisation
turns into steps of either sign), and see the same batches (the same
`random.Random` crops, the same tokenizer). Losses agree within LOSS_RTOL
plus LOSS_ATOL: the logits are cosines / 0.05, up to 20, whose fp32
rounding in sums of other orders moves the loss by ~1e-6. After the AdamW steps every parameter agrees
within PARAM_TOL, except the attention's key biases: softmax ignores a
constant added to a row of scores, so their gradient is zero in exact
arithmetic and fp32 noise in both packages, which AdamW turns into steps of
about lr either way; they are held to that bound (KEY_BIAS_TOL).
"""
import random
import sqlite3
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import eioku_tpu.parallel.finetune as jax_ft
from eioku_tpu.models.checkpoint import load_params as jax_load_params
from eioku_tpu.models.checkpoint import save_params as jax_save_params
from eioku_tpu.models.embed import minilm as jml
from eioku_tpu.models.embed.tokenizer import WordPieceTokenizer as JaxTokenizer
from eioku_tpu.parallel.train import info_nce_loss as jax_info_nce_loss
from eioku_tpu.parallel.train import make_train_step as jax_make_train_step
import eioku_tpu_torch.parallel.finetune as port_ft
from eioku_tpu_torch.db.connection import Database
from eioku_tpu_torch.db.migrations import run_migrations
from eioku_tpu_torch.models.checkpoint import load_params, save_params
from eioku_tpu_torch.models.embed import minilm as pml
from eioku_tpu_torch.parallel import mesh as port_mesh
from eioku_tpu_torch.parallel.train import adamw, info_nce_loss, make_train_step

TINY = dict(vocab_size=30522, dim=32, n_layers=2, n_heads=2, ffn_dim=64,
            max_position=128)
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-5
LR = 1e-3
PARAM_TOL = 1e-3 * LR
STEPS = 3
KEY_BIAS_TOL = 2 * LR * STEPS * 1.01  # opposite steps of about lr each
CPU = torch.device("cpu")
BATCH = 8
WORDS = ("meeting beach sunset dog cat birthday cake garden hiking snow city car "
         "bridge concert guitar kitchen recipe soccer goal lake boat camera").split()


def _texts(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(3, 16)))) for _ in range(n)]


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One intra-op thread for torch on the CPU (as tests/test_torch_ocr.py
    does): the suite's workers share the cores, and with a pool each the
    many small ops of these steps wait on descheduled threads (a step of
    milliseconds took tens of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    t = jax.tree.map(np.asarray, jml.init_minilm_params(jml.MiniLMConfig(**TINY), seed=0))
    t["tok_emb"] = t["tok_emb"] * 100.0
    return t


def assert_trees_close(got: dict, want: dict) -> None:
    """Every leaf within PARAM_TOL, the key biases within KEY_BIAS_TOL."""
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for (path, w), g in zip(flat, jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        tol = KEY_BIAS_TOL if name.endswith("['k']['b']") else PARAM_TOL
        assert g.shape == w.shape, name
        assert float(np.abs(g - np.asarray(w)).max()) <= tol, name


def _port_model(tree) -> pml.MiniLM:
    cfg = pml.MiniLMConfig(**TINY)
    return pml.load_state(pml.MiniLM(cfg), pml.from_jax_params(tree))


def _batch(texts, seed):
    """(anchor ids, mask, positive ids, mask) of BATCH crops, as both
    fine-tunes draw them."""
    rng = random.Random(seed)
    pairs = [jax_ft.crop_pair(rng.choice(texts), rng) for _ in range(BATCH)]
    tok = JaxTokenizer(max_len=128)
    a = tok.encode_batch([a for a, _ in pairs])
    p = tok.encode_batch([p for _, p in pairs])
    return (*a, *p)


def test_crop_pair_matches_jax():
    texts = _texts(20) + ["one two", "a b c d", ""]
    r1, r2 = random.Random(3), random.Random(3)
    for t in texts * 3:
        assert port_ft.crop_pair(t, r1) == jax_ft.crop_pair(t, r2)
    assert r1.random() == r2.random()


def test_info_nce_loss_matches_jax(tree):
    jcfg = jml.MiniLMConfig(**TINY)
    batch = _batch(_texts(30), seed=1)
    want = float(jax_info_nce_loss(tree, *map(jnp.asarray, batch), jcfg))
    got = info_nce_loss(_port_model(tree), *(torch.from_numpy(x) for x in batch))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_train_steps_match_jax(tree):
    """Three AdamW steps on the same batches (single device on the JAX
    side: its step jitted without a mesh)."""
    jcfg = jml.MiniLMConfig(**TINY)
    texts = _texts(30)
    step, opt = jax_make_train_step(jcfg, optax.adamw(LR))
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    model = _port_model(tree)
    pstep, popt = make_train_step(model, adamw(model, LR))
    assert popt.defaults["weight_decay"] == 1e-4
    for i in range(STEPS):
        batch = _batch(texts, seed=10 + i)
        params, state, jloss = step(params, state, *map(jnp.asarray, batch))
        loss = pstep(*(torch.from_numpy(x) for x in batch))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    want = jax.tree.map(np.asarray, params)
    assert_trees_close(pml.to_jax_params(model), want)
    for w, s in zip(jax.tree.leaves(want), jax.tree.leaves(tree)):
        assert np.abs(w - s).max() > 0  # every leaf moved (the decay at least)


def test_native_checkpoints_load_across(tree, tmp_path):
    # the port's file in the JAX package's load_minilm, and the reverse
    jcfg, pcfg = jml.MiniLMConfig(**TINY), pml.MiniLMConfig(**TINY)
    model = _port_model(tree)
    (tmp_path / "port" / "minilm-l6").mkdir(parents=True)
    save_params(pml.to_jax_params(model), str(tmp_path / "port" / "minilm-l6" / "native.npz"))
    loaded, _, pretrained = jml.load_minilm(str(tmp_path / "port"), cfg=jcfg)
    assert pretrained
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jax_save_params(tree, str(tmp_path / "jax" / "minilm-l6" / "native.npz"))
    back, _, pretrained = pml.load_minilm(str(tmp_path / "jax"), cfg=pcfg)
    assert pretrained
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # load_params keeps the template's structure and checks shapes, as JAX's
    path = str(tmp_path / "port" / "minilm-l6" / "native.npz")
    got, want = load_params(tree, path), jax_load_params(tree, path)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    small = jax.tree.map(np.asarray, jml.init_minilm_params(
        jml.MiniLMConfig(**{**TINY, "dim": 16, "ffn_dim": 32}), seed=0))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_params(small, path)
    with pytest.raises(KeyError):
        load_params({"nope": np.zeros(1)}, path)


@pytest.fixture()
def corpus(tmp_path):
    """A library database whose embedding_chunks hold 24 seeded chunks (and
    two too short to train on)."""
    url = f"sqlite:///{tmp_path}/lib.db"
    db = Database(url)
    run_migrations(db)
    db.close()
    con = sqlite3.connect(str(tmp_path / "lib.db"))
    for i, t in enumerate(_texts(24, seed=5) + ["too short", "one"]):
        con.execute("INSERT INTO embedding_chunks (slot, artifact_id, asset_id, start_ms, "
                    "end_ms, text, source, model, run_id) VALUES (?,?,?,?,?,?,?,?,?)",
                    (i, f"a{i}", "v1", i * 1000, i * 1000 + 900, t, "transcript",
                     "minilm", "r1"))
    con.commit()
    con.close()
    return url


def _ctx(db, cache):
    return types.SimpleNamespace(db=db, config=types.SimpleNamespace(model_cache_dir=cache))


def test_finetune_embedder_matches_jax(tree, corpus, tmp_path, monkeypatch):
    from eioku_tpu.db.connection import Database as JaxDatabase

    jcfg, pcfg = jml.MiniLMConfig(**TINY), pml.MiniLMConfig(**TINY)
    monkeypatch.setattr(jax_ft, "load_minilm", lambda cache: (
        jax.tree.map(jnp.asarray, tree), jcfg, False))
    monkeypatch.setattr(port_ft, "load_minilm", lambda cache, device="cpu": (
        _port_model(tree).to(device), pcfg, False))
    caches = {side: str(tmp_path / side) for side in ("jax", "port")}
    jdb, pdb = JaxDatabase(corpus), Database(corpus)
    try:
        want = jax_ft.finetune_embedder(_ctx(jdb, caches["jax"]), steps=STEPS,
                                        batch_size=BATCH, lr=LR)
        got = port_ft.finetune_embedder(_ctx(pdb, caches["port"]), steps=STEPS,
                                        batch_size=BATCH, lr=LR, device="cpu")
        with pytest.raises(ValueError, match="indexed chunks"):
            port_ft.finetune_embedder(_ctx(pdb, caches["port"]), batch_size=25,
                                      device="cpu")
    finally:
        jdb.close()
        pdb.close()
    assert set(got) == set(want)
    assert got["steps"] == want["steps"] == STEPS and got["chunks"] == want["chunks"] == 24
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert want["mesh"]["data"] == len(jax.devices())  # the JAX run is sharded
    assert got["mesh"] == {"data": 1, "model": 1}
    assert got["checkpoint"] == f"{caches['port']}/minilm-l6/native.npz"
    # each package's saved tree loads in the other's load_minilm
    jparams, _, pre = jml.load_minilm(caches["port"], cfg=jcfg)
    model, _, pre2 = pml.load_minilm(caches["jax"], cfg=pcfg)
    assert pre and pre2
    assert_trees_close(pml.to_jax_params(model), jax.tree.map(np.asarray, jparams))


def test_finetune_rounds_the_batch_as_jax(tree, corpus, tmp_path, monkeypatch):
    """An odd batch: on its one CPU device the port does not round it; given
    as many devices as the JAX package (conftest's host devices, as
    `local_devices` of [cpu] * n), it rounds it as the JAX mesh's data axis
    does, draws the same pairs and takes the same step."""
    from eioku_tpu.db.connection import Database as JaxDatabase

    n = len(jax.devices())
    odd = n - 3
    jcfg, pcfg = jml.MiniLMConfig(**TINY), pml.MiniLMConfig(**TINY)
    monkeypatch.setattr(jax_ft, "load_minilm", lambda cache: (
        jax.tree.map(jnp.asarray, tree), jcfg, False))
    monkeypatch.setattr(port_ft, "load_minilm", lambda cache, device="cpu": (
        _port_model(tree).to(device), pcfg, False))
    drawn = {"jax": [], "port": []}
    for side, mod in (("jax", jax_ft), ("port", port_ft)):
        monkeypatch.setattr(mod, "crop_pair", lambda text, rng, _f=mod.crop_pair,
                            _d=drawn[side]: _d.append(text) or _f(text, rng))
    jdb, pdb = JaxDatabase(corpus), Database(corpus)
    try:
        port_ft.finetune_embedder(_ctx(pdb, str(tmp_path / "one")), steps=1,
                                  batch_size=odd, lr=LR, device="cpu")
        assert len(drawn["port"]) == odd
        drawn["port"].clear()
        want = jax_ft.finetune_embedder(_ctx(jdb, str(tmp_path / "jax")), steps=1,
                                        batch_size=odd, lr=LR)
        monkeypatch.setattr(port_mesh, "local_devices", lambda device=None: [CPU] * n)
        got = port_ft.finetune_embedder(_ctx(pdb, str(tmp_path / "port")), steps=1,
                                        batch_size=odd, lr=LR, device="cpu")
    finally:
        jdb.close()
        pdb.close()
    assert want["mesh"]["data"] == n and len(drawn["jax"]) == n
    assert got["mesh"] == want["mesh"]
    assert drawn["port"] == drawn["jax"]
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("model_parallel,n_devices", [
    (2, 8),  # MiniLM tensor-parallel over 2 of 8: the (data 4, model 2) mesh
    (3, 8),  # 3 does not divide 8: model_parallel 1 on both sides
    (4, 8),  # 4 does not divide TINY's 2 heads: the warning and model_parallel 1
    (2, 1),  # one device: model_parallel 1, where JAX's 8 host devices shard
])
def test_finetune_model_parallel_matches_jax(tree, corpus, tmp_path, monkeypatch,
                                             model_parallel, n_devices):
    """finetune_embedder(model_parallel=...) on the port's mesh of
    n_devices CPU entries against the JAX package's on conftest's host
    devices: the losses, the saved checkpoint (in either package's
    load_minilm) and stats["mesh"], which is the JAX package's
    `dict(mesh.shape)` wherever the two see as many devices."""
    from eioku_tpu.db.connection import Database as JaxDatabase

    jcfg, pcfg = jml.MiniLMConfig(**TINY), pml.MiniLMConfig(**TINY)
    monkeypatch.setattr(jax_ft, "load_minilm", lambda cache: (
        jax.tree.map(jnp.asarray, tree), jcfg, False))
    monkeypatch.setattr(port_ft, "load_minilm", lambda cache, device="cpu": (
        _port_model(tree).to(device), pcfg, False))
    monkeypatch.setattr(port_mesh, "local_devices", lambda device=None: [CPU] * n_devices)
    caches = {side: str(tmp_path / side) for side in ("jax", "port")}
    jdb, pdb = JaxDatabase(corpus), Database(corpus)
    try:
        want = jax_ft.finetune_embedder(_ctx(jdb, caches["jax"]), steps=STEPS,
                                        batch_size=BATCH, lr=LR,
                                        model_parallel=model_parallel)
        got = port_ft.finetune_embedder(_ctx(pdb, caches["port"]), steps=STEPS,
                                        batch_size=BATCH, lr=LR, device="cpu",
                                        model_parallel=model_parallel)
    finally:
        jdb.close()
        pdb.close()
    if n_devices == len(jax.devices()):
        assert got["mesh"] == want["mesh"]
    else:
        assert got["mesh"] == {"data": 1, "model": 1} != want["mesh"]
    assert want["mesh"]["model"] == (2 if model_parallel == 2 else 1)
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    jparams, _, pre = jml.load_minilm(caches["port"], cfg=jcfg)
    model, _, pre2 = pml.load_minilm(caches["jax"], cfg=pcfg)
    assert pre and pre2
    assert_trees_close(pml.to_jax_params(model), jax.tree.map(np.asarray, jparams))
