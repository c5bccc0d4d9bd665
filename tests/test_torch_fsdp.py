"""The port's multi-device training (parallel/fsdp.py, parallel/train.py's
mesh step, models/embed/minilm.py `embed_tp`, models/checkpoint.py's
sharded checkpoints, parallel/collectives.py's training collectives)
against the JAX package, on the CPU at fp32.

The JAX side runs on conftest's 8 virtual host devices: `make_fsdp_train_step`
on an 8-way data mesh and `make_train_step` on `shard_minilm_params` over
the (data 4, model 2) mesh of tests/test_parallel.py. The port's meshes are
the same grids over `local_devices` replaced by `[cpu] * 8` (one process,
backend a of parallel/collectives.py). Both start from one seeded MiniLM
tree (`from_jax_params`) and see the same numpy batches.

Tolerances are the JAX package's own FSDP test's (tests/test_parallel.py
TestFsdp): the loss within LOSS_RTOL / LOSS_ATOL, the gathered parameters
after two AdamW steps within PARAM_RTOL / PARAM_ATOL. AdamW's steps do not
show a gradient's scale (a gradient taken tp times over steps alike), so
the first step's gathered gradients are held to `jax.grad` of the JAX loss
as well, within GRAD_RTOL of each leaf's largest |value|. The token embeddings
are scaled by 100 (hazard l of ROADMAP.md: random weights leave ~1e-8
gradients, which AdamW turns into steps of either sign). The attention's
key biases are held to the step bound KEY_BIAS_TOL instead: softmax
ignores a constant added to a row of scores, so their gradient is zero in
exact arithmetic and fp32 noise on either side, as in
tests/test_torch_finetune.py.

A mesh that names "cpu" and "cpu:0" side by side has two devices that are
one: the parameters it copies per device are distinct tensors, which
exercises the gradient sum over copies (`sum_copies`) that distinct cards
in one process need.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from eioku_tpu.models.checkpoint import restore_sharded as jax_restore_sharded
from eioku_tpu.models.checkpoint import save_sharded as jax_save_sharded
from eioku_tpu.models.embed import minilm as jml
from eioku_tpu.parallel import fsdp as jax_fsdp
from eioku_tpu.parallel import mesh as jax_mesh
from eioku_tpu.parallel.train import info_nce_loss as jax_info_nce_loss
from eioku_tpu.parallel.train import make_train_step as jax_make_train_step
import eioku_tpu_torch.models.checkpoint as ckpt
from eioku_tpu_torch.models.embed import minilm as pml
from eioku_tpu_torch.parallel import fsdp, mesh
from eioku_tpu_torch.parallel.collectives import LocalCollectives
from eioku_tpu_torch.parallel.mesh import Mesh, ShardedTensor
from eioku_tpu_torch.parallel.train import adamw, info_nce_loss, make_train_step

CPU = torch.device("cpu")
TWIN = torch.device("cpu", 0)  # the CPU under another name: a "second" device
CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, ffn_dim=128, max_position=64)
ODD = dict(vocab_size=500, dim=36, n_layers=1, n_heads=4, ffn_dim=72, max_position=64)
LR = 1e-3
STEPS = 2
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4
KEY_BIAS_TOL = 2 * LR * STEPS * 1.01  # opposite steps of about lr each
GRAD_RTOL = 1e-4  # fp32 sums of other orders, relative to the leaf's largest |value|


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


@pytest.fixture()
def cpu8(monkeypatch):
    monkeypatch.setattr(mesh, "local_devices", lambda device=None: [CPU] * 8)


def _tree(cfg: dict, seed: int = 0) -> dict:
    t = jax.tree.map(np.asarray, jml.init_minilm_params(jml.MiniLMConfig(**cfg), seed=seed))
    t["tok_emb"] = t["tok_emb"] * 100.0
    return t


def _model(tree, cfg: dict) -> pml.MiniLM:
    return pml.load_state(pml.MiniLM(pml.MiniLMConfig(**cfg)), pml.from_jax_params(tree))


def _batch(cfg: dict, seed: int, ragged: bool, b: int = 16, s: int = 32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg["vocab_size"], (b, s)).astype(np.int32)
    pos = rng.integers(0, cfg["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if ragged:
        for i, n in enumerate(rng.integers(1, s + 1, b)):
            mask[i, n:] = 0
    return ids, mask, pos, mask


def assert_state_close(got: dict, tree) -> None:
    """The port's state dict against a JAX tree: PARAM tolerances, the key
    biases within KEY_BIAS_TOL."""
    want = pml.from_jax_params(jax.tree.map(np.asarray, tree))
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].detach().numpy()
        if name.endswith("attention.self.key.bias"):
            assert float(np.abs(g - w).max()) <= KEY_BIAS_TOL, name
        else:
            np.testing.assert_allclose(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)


def assert_grads_close(got: dict, tree, cfg: dict, batch) -> None:
    """The port's gradients against jax.grad of the JAX loss on the whole
    tree, each leaf within GRAD_RTOL of its largest |value| (a key bias's
    scale is its layer's query bias's: its own is zero in exact
    arithmetic)."""
    g = jax.grad(jax_info_nce_loss)(jax.tree.map(jnp.asarray, tree),
                                    *map(jnp.asarray, batch), jml.MiniLMConfig(**cfg))
    want = pml.from_jax_params(jax.tree.map(np.asarray, g))
    assert set(want) == set(got)
    for name, w in want.items():
        scale = np.abs(want[name.replace("key.bias", "query.bias")]).max()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


# -- fsdp_spec ----------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 64), (32, 256), (7,), (), (64, 64), (30522, 384),
                                   (384, 1536), (2, 384), (500, 36)])
def test_fsdp_spec_as_jax(shape):
    want = jax_fsdp.fsdp_spec(shape, 8)
    dims = [d for d, a in enumerate(want) if a == "data"]
    assert fsdp.fsdp_spec(shape, 8) == (dims[0] if dims else None)


def test_shard_tree_fsdp_layout(cpu8):
    """The JAX test's layout: a divisible leaf in eighths, an indivisible
    one whole and shared by the entries of one device."""
    m = mesh.make_mesh(8)
    out = fsdp.shard_tree_fsdp({"w": torch.ones(64, 16), "b": np.ones(7, np.float32)}, m)
    assert [tuple(p.shape) for p in out["w"].parts] == [(8, 16)] * 8
    assert out["b"].dim is None and len(out["b"].unique_parts()) == 1
    assert torch.equal(out["w"].full(), torch.ones(64, 16))
    with pytest.raises(ValueError, match="model axis"):
        fsdp.shard_tree_fsdp({"w": torch.ones(4)}, mesh.make_mesh(8, model_parallel=2))


# -- the collectives training needs ---------------------------------------------------------


def test_reduce_scatter_and_megatron_pair_by_definition():
    """Backend (a): reduce_scatter keeps piece i of the sum; the Megatron
    pair and all_gather under autograd give every part its gradient of
    one loss taken from the first shard."""
    comm = LocalCollectives(["cpu"] * 3)
    xs = [torch.arange(12.0).reshape(6, 2) * (i + 1) for i in range(3)]
    total = xs[0] + xs[1] + xs[2]
    assert all(torch.equal(t, total[2 * i:2 * i + 2]) for i, t in
               enumerate(comm.reduce_scatter(xs, dim=0)))
    parts = [x.clone().requires_grad_(True) for x in xs]
    sums = comm.reduce_from_line(parts)
    assert all(torch.equal(s, total) for s in sums)
    (sums[0] ** 2).sum().backward()
    assert all(torch.equal(p.grad, 2 * total) for p in parts)  # psum forward, identity back
    x = torch.ones(2, 2, requires_grad=True)
    ins = comm.copy_to_line([x] * 3)
    (ins[0] * 1 + ins[1] * 2 + ins[2] * 3).sum().backward()
    assert torch.equal(x.grad, torch.full((2, 2), 6.0))  # the uses' gradients summed
    parts = [torch.full((1, 2), float(i), requires_grad=True) for i in range(3)]
    full = comm.all_gather(parts, dim=0)
    sum(f.sum() * (k + 1) for k, f in enumerate(full)).backward()
    assert all(torch.equal(p.grad, torch.full((1, 2), 6.0)) for p in parts)


# -- embed_tp -------------------------------------------------------------------------------


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"], ["cpu"] * 4, ["cpu", TWIN]])
def test_embed_tp_matches_jax_and_one_device(devices):
    tree = _tree(CFG)
    model = _model(tree, CFG)
    ids, mask, _, _ = _batch(CFG, seed=4, ragged=True, b=6, s=24)
    want = np.asarray(jml.minilm_embed(tree, jnp.asarray(ids), jnp.asarray(mask),
                                       jml.MiniLMConfig(**CFG)))
    one = pml.minilm_embed(model, _t(ids), _t(mask))
    m = Mesh([devices])
    shards = mesh.shard_minilm_params(model, m)[0]
    outs = pml.embed_tp(shards, m.lines("model")[0], _t(ids), _t(mask), model.cfg)
    assert len(outs) == len(devices)
    for out in outs:
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(out.detach().numpy(), one.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        pml.embed_tp(shards * 2, LocalCollectives(["cpu"] * 3), _t(ids), _t(mask), model.cfg)


# -- the DP x TP step -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dp_tp():
    """Two AdamW steps of the JAX step on shard_minilm_params over (data
    4, model 2), for each batch: (losses, params after the steps)."""
    out = {}
    jmesh = jax_mesh.make_mesh(8, model_parallel=2)
    sh = NamedSharding(jmesh, P("data"))
    for ragged in (False, True):
        params = jax_mesh.shard_minilm_params(jax.tree.map(jnp.asarray, _tree(CFG)), jmesh)
        step, opt = jax_make_train_step(jml.MiniLMConfig(**CFG), optax.adamw(LR))
        state = opt.init(params)
        losses = []
        with jmesh:
            for i in range(STEPS):
                batch = [jax.device_put(jnp.asarray(x), sh)
                         for x in _batch(CFG, seed=10 + i, ragged=ragged)]
                params, state, loss = step(params, state, *batch)
                losses.append(float(loss))
        out[ragged] = (losses, jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("grid,ragged", [
    ("mesh8", False),  # make_mesh(8, model_parallel=2) over [cpu] * 8
    ("mesh8", True),   # ragged masks
    ("twins", True),   # the same grid with cpu and cpu:0 alternating
])
def test_dp_tp_steps_match_jax(cpu8, jax_dp_tp, grid, ragged):
    """Each data line sees its own rows; the loss is in-batch over the
    global batch, which a per-shard InfoNCE would miss by far more than
    the tolerance (checked on the first batch)."""
    m = (mesh.make_mesh(8, model_parallel=2) if grid == "mesh8"
         else Mesh([[CPU, TWIN], [TWIN, CPU]] * 2))
    assert m.shape == {"data": 4, "model": 2}
    model = _model(_tree(CFG), CFG)
    step, opt = make_train_step(model, lambda ps: adamw(ps, LR), m)
    assert opt.defaults["weight_decay"] == 1e-4
    want_losses, want_params = jax_dp_tp[ragged]
    for i in range(STEPS):
        loss = step(*(_t(x) for x in _batch(CFG, seed=10 + i, ragged=ragged)))
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        if i == 0:
            assert_grads_close(step.gradients(), _tree(CFG), CFG,
                               _batch(CFG, seed=10, ragged=ragged))
    assert_state_close(step.state_dict(), want_params)
    batch = [_t(x) for x in _batch(CFG, seed=10, ragged=ragged)]
    fresh = _model(_tree(CFG), CFG)
    with torch.no_grad():
        per_shard = np.mean([float(info_nce_loss(fresh, *(x[4 * r:4 * r + 4] for x in batch)))
                             for r in range(4)])
    assert abs(per_shard - want_losses[0]) > 100 * (LOSS_ATOL + LOSS_RTOL * want_losses[0])


# -- FSDP ------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fsdp_run():
    """The JAX test's two FSDP steps over an all-data 8-way mesh, for CFG
    and ODD (whose indivisible leaves stay whole): (losses, params)."""
    out = {}
    jm = jax_mesh.make_mesh(8, model_parallel=1)
    for name, cfg in (("cfg", CFG), ("odd", ODD)):
        step, _, prepare = jax_fsdp.make_fsdp_train_step(jml.MiniLMConfig(**cfg), jm,
                                                         optax.adamw(LR))
        params, state = prepare(jax.tree.map(jnp.asarray, _tree(cfg)))
        losses = []
        for i in range(STEPS):
            params, state, loss = step(params, state, *map(
                jnp.asarray, _batch(cfg, seed=20 + i, ragged=True)))
            losses.append(float(loss))
        out[name] = (losses, jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("cfg_name,twins", [("cfg", False), ("odd", False), ("odd", True)])
def test_fsdp_steps_match_jax(cpu8, jax_fsdp_run, cfg_name, twins):
    cfg = {"cfg": CFG, "odd": ODD}[cfg_name]
    m = mesh.make_mesh(8) if not twins else Mesh([[CPU], [TWIN]] * 4)
    model = _model(_tree(cfg), cfg)
    step, _, prepare = fsdp.make_fsdp_train_step(model, m, lambda ps: adamw(ps, LR))
    params, state = prepare(model)
    whole = [k for k, v in params.items() if v.dim is None]
    if cfg_name == "odd":  # [500, 36] divides by 8 in neither dimension
        assert "embeddings.word_embeddings.weight" in whole
    else:
        assert not whole
        assert fsdp.max_leaf_shard_fraction(params) <= 1 / 8
        assert fsdp.max_leaf_shard_fraction(state) <= 1 / 8
    want_losses, want_params = jax_fsdp_run[cfg_name]
    for i in range(STEPS):
        params, state, loss = step(params, state, *(
            _t(x) for x in _batch(cfg, seed=20 + i, ragged=True)))
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        if i == 0:
            assert_grads_close(fsdp.gradients(params), _tree(cfg), cfg,
                               _batch(cfg, seed=20, ragged=True))
    assert float(state["step"]) == STEPS
    if cfg_name == "cfg":  # every leaf cut: the layout held
        assert fsdp.max_leaf_shard_fraction(params) <= 1 / 8
        assert fsdp.max_leaf_shard_fraction(state) <= 1 / 8
    assert_state_close(fsdp.gather_tree(params), want_params)


def test_fsdp_rejects_what_it_cannot_shard(cpu8):
    model = _model(_tree(CFG), CFG)
    with pytest.raises(ValueError, match="data axis"):
        fsdp.make_fsdp_train_step(model, mesh.make_mesh(8), axis="model")
    step, _, prepare = fsdp.make_fsdp_train_step(model, mesh.make_mesh(8))
    params, state = prepare(model)
    with pytest.raises(ValueError, match="must divide"):
        step(params, state, *(_t(x) for x in _batch(CFG, seed=0, ragged=False, b=12)))


# -- sharded checkpoints ------------------------------------------------------------------


def _fsdp_state(m: Mesh, seed: int = 3):
    model = _model(_tree(CFG, seed), CFG)
    step, _, prepare = fsdp.make_fsdp_train_step(model, m, lambda ps: adamw(ps, LR))
    return model, step, prepare


def _equal_trees(a, b) -> bool:
    la, lb = mesh.tree_leaves(fsdp.gather_tree(a)), mesh.tree_leaves(fsdp.gather_tree(b))
    return len(la) == len(lb) and all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("target", ["same", "data2", "whole", "tensors"])
def test_sharded_checkpoint_round_trip_and_reshard(cpu8, tmp_path, target):
    """An FSDP train state (parameters, both moments and the step, after
    one step) saved over 8 entries restores bit-equal into the same layout,
    into 2 entries, into 1, and into plain tensors."""
    model, step, prepare = _fsdp_state(mesh.make_mesh(8))
    p, o = prepare(model)
    p, o, _ = step(p, o, *(_t(x) for x in _batch(CFG, seed=1, ragged=True)))
    saved = {"params": p, "opt": o}
    ckpt.save_sharded(saved, str(tmp_path / "ck"))
    assert sorted(x.name for x in tmp_path.iterdir()) == ["ck"]  # published, no leftovers
    if target == "same":
        template = saved
    elif target == "tensors":
        template = fsdp.gather_tree(saved)
    else:
        p2, o2 = fsdp.make_fsdp_train_step(model, mesh.make_mesh(
            2 if target == "data2" else 1))[2](model)
        template = {"params": p2, "opt": o2}
    back = ckpt.restore_sharded(template, str(tmp_path / "ck"))
    assert _equal_trees(back, saved)
    frac = {"same": 1 / 8, "data2": 1 / 2, "whole": 1.0, "tensors": 1.0}[target]
    assert fsdp.max_leaf_shard_fraction(back) == frac
    if target != "tensors":
        part = back["params"]["encoder.layer.0.intermediate.dense.weight"].parts[0]
        assert part.requires_grad  # restored parameters train
    with pytest.raises(KeyError):
        ckpt.restore_sharded({"nope": torch.zeros(2)}, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_sharded({"opt": {"step": torch.zeros(3)}}, str(tmp_path / "ck"))


def test_resume_matches_continuous_run(cpu8, tmp_path):
    """save -> restore -> one more step == two uninterrupted steps, bit for
    bit, also when the resume runs on 2 entries."""
    model, step, prepare = _fsdp_state(mesh.make_mesh(8), seed=5)
    batch = [_t(x) for x in _batch(CFG, seed=2, ragged=True)]
    p, o = prepare(model)
    p, o, _ = step(p, o, *batch)
    ckpt.save_sharded({"params": p, "opt": o}, str(tmp_path / "mid"))
    state = ckpt.restore_sharded({"params": p, "opt": o}, str(tmp_path / "mid"))
    p2, o2, loss_cont = step(p, o, *batch)
    p3, o3, loss_res = step(state["params"], state["opt"], *batch)
    assert float(loss_res) == float(loss_cont)
    assert _equal_trees({"p": p3, "o": o3}, {"p": p2, "o": o2})
    step2, _, prepare2 = fsdp.make_fsdp_train_step(model, mesh.make_mesh(2),
                                                   lambda ps: adamw(ps, LR))
    p4, o4 = prepare2(model)
    state2 = ckpt.restore_sharded({"params": p4, "opt": o4}, str(tmp_path / "mid"))
    _, _, loss_two = step2(state2["params"], state2["opt"], *batch)
    np.testing.assert_allclose(float(loss_two), float(loss_cont), rtol=1e-6)


def test_save_that_dies_leaves_the_last_checkpoint(cpu8, tmp_path, monkeypatch):
    model, step, prepare = _fsdp_state(mesh.make_mesh(8))
    p, o = prepare(model)
    path = str(tmp_path / "ck")
    ckpt.save_sharded({"params": p, "opt": o}, path)
    before = mesh.tree_map(torch.clone, fsdp.gather_tree({"params": p, "opt": o}))
    p, o, _ = step(p, o, *(_t(x) for x in _batch(CFG, seed=1, ragged=False)))
    calls = {"n": 0}
    real = ckpt._write_part

    def dies(*args):
        calls["n"] += 1
        if calls["n"] == 7:
            raise OSError("disk gone")
        return real(*args)
    monkeypatch.setattr(ckpt, "_write_part", dies)
    with pytest.raises(OSError, match="disk gone"):
        ckpt.save_sharded({"params": p, "opt": o}, path)
    back = ckpt.restore_sharded({"params": p, "opt": o}, path)
    assert _equal_trees(back, before)
    monkeypatch.setattr(ckpt, "_write_part", real)
    ckpt.save_sharded({"params": p, "opt": o}, path)  # a later save publishes
    assert _equal_trees(ckpt.restore_sharded({"params": p, "opt": o}, path),
                        {"params": p, "opt": o})
    assert sorted(x.name for x in tmp_path.iterdir()) == ["ck"]


def test_checkpoint_values_as_jax(cpu8, tmp_path):
    """One seeded tree (the JAX test's), FSDP-cut on both sides, saved
    and restored by each package: the same values."""
    cfg = dict(vocab_size=256, dim=64, n_layers=1, n_heads=4, ffn_dim=128, max_position=32)
    tree = jml.init_minilm_params(jml.MiniLMConfig(**cfg), seed=3)
    jm = jax_mesh.make_mesh(8, model_parallel=1)
    jax_save_sharded(jax_fsdp.shard_tree_fsdp(tree, jm), str(tmp_path / "jax"))
    want = jax_restore_sharded(jax_fsdp.shard_tree_fsdp(tree, jm), str(tmp_path / "jax"))
    cut = fsdp.shard_tree_fsdp(jax.tree.map(np.asarray, tree), mesh.make_mesh(8))
    assert isinstance(cut["layers"][0]["q"]["w"], ShardedTensor)
    ckpt.save_sharded(cut, str(tmp_path / "port"))
    got = fsdp.gather_tree(ckpt.restore_sharded(cut, str(tmp_path / "port")))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == len(mesh.tree_leaves(got))
    for path, w in flat_want:
        node = got
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(w))
