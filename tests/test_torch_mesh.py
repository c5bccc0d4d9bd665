"""The port's mesh and process-group start-up, pipeline parallelism, ring
attention and expert-parallel MoE (parallel/mesh.py, parallel/pipeline.py,
ops/ring_attention.py, ops/moe.py) against the JAX package, on the CPU.

The JAX side runs on conftest's 8 virtual host devices, on the (data 4,
model 2) mesh of tests/test_parallel.py; the port's mesh is the same grid
over `local_devices` replaced by `[cpu] * 8` (one process, backend a of
parallel/collectives.py). Inputs and parameters are made once with numpy
and handed to both. Tolerances: the pipeline atol 1e-5 (fp32 tanh layers,
the JAX test's); ring attention atol 2e-5 against the JAX ring and the
full-attention reference (fp32 online softmax, blocks summed in one order
on both sides); MoE rtol 1e-4, atol 1e-5 (the JAX tests').
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eioku_tpu.models.embed import minilm as jml
from eioku_tpu.ops import moe as jax_moe
from eioku_tpu.ops.flash_attention import _reference_attention
from eioku_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from eioku_tpu.parallel import mesh as jax_mesh
from eioku_tpu.parallel import pipeline as jax_pipeline
from eioku_tpu_torch.models.embed import minilm as pml
from eioku_tpu_torch.ops import moe
from eioku_tpu_torch.ops.flash_attention import flash_attention_plain
from eioku_tpu_torch.ops.ring_attention import MASK_VALUE, ring_attention
from eioku_tpu_torch.parallel import mesh, pipeline

CPU = torch.device("cpu")


@pytest.fixture()
def cpu8(monkeypatch):
    """The port's device list: eight CPU entries, as conftest gives JAX."""
    monkeypatch.setattr(mesh, "local_devices", lambda device=None: [CPU] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    return jax_mesh.make_mesh(8, model_parallel=2)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- mesh -------------------------------------------------------------------------------


@pytest.mark.parametrize("n,mp,shape", [(8, 2, {"data": 4, "model": 2}),
                                        (None, 1, {"data": 8, "model": 1}),
                                        (4, 4, {"data": 1, "model": 4})])
def test_make_mesh_shape_as_jax(cpu8, n, mp, shape):
    got = mesh.make_mesh(n, model_parallel=mp)
    assert got.shape == shape == dict(jax_mesh.make_mesh(n, model_parallel=mp).shape)
    assert got.devices == [[CPU] * shape["model"]] * shape["data"]


@pytest.mark.parametrize("n,mp", [(8, 3), (9, 1)])
def test_make_mesh_errors_as_jax(cpu8, n, mp):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(n, model_parallel=mp)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(n, model_parallel=mp)
    assert str(got.value) == str(want.value)


def test_local_devices_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.local_devices("cpu") == [CPU]
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.local_devices()


def test_placement_shares_repeated_entries(cpu8):
    m = mesh.make_mesh(8, model_parallel=2)
    x = torch.arange(8.0).reshape(4, 2)
    rep = mesh.replicated(m, x)
    assert all(t is rep[0][0] for row in rep for t in row)
    shards = mesh.data_sharded(m, x)
    for i, row in enumerate(shards):
        assert all(torch.equal(t, x[i:i + 1]) for t in row)


def test_initialize_distributed_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("EIOKU_COORDINATOR", raising=False)
    assert mesh.initialize_distributed() is False
    assert jax_mesh.initialize_distributed() is False


@pytest.mark.parametrize("num_processes,process_id", [(2, 5), (2, -1)])
def test_initialize_distributed_rejects_bad_process_id(num_processes, process_id):
    for fn in (jax_mesh.initialize_distributed, mesh.initialize_distributed):
        with pytest.raises(ValueError, match="out of range"):
            fn(coordinator="127.0.0.1:9999", num_processes=num_processes,
               process_id=process_id)


def test_initialize_distributed_reads_the_environment(monkeypatch):
    """The variables are read and validated as in the JAX package; a host
    without CUDA that did not ask for the CPU raises before any group
    starts (no fallback from NCCL to gloo)."""
    monkeypatch.setenv("EIOKU_COORDINATOR", "127.0.0.1:9")
    monkeypatch.setenv("EIOKU_NUM_PROCESSES", "2")
    monkeypatch.setenv("EIOKU_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="out of range"):
        mesh.initialize_distributed()
    monkeypatch.setenv("EIOKU_PROCESS_ID", "1")
    monkeypatch.delenv("EIOKU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_shard_minilm_params_as_jax_spec(cpu8, jmesh8):
    """Every device's shard of every parameter equals the JAX package's
    shard on the device at the same mesh position (`_minilm_spec`)."""
    cfg = jml.MiniLMConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                           ffn_dim=128, max_position=32)
    params = jax.tree.map(np.asarray, jml.init_minilm_params(cfg, 0))
    model = pml.MiniLM(pml.MiniLMConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                                        ffn_dim=128, max_position=32))
    model.load_state_dict({k: _t(v) for k, v in pml.from_jax_params(params).items()})
    got = mesh.shard_minilm_params(model, mesh.make_mesh(8, model_parallel=2))
    placed = jax_mesh.shard_minilm_params(params, jmesh8)
    position = {d: (i, j) for i, row in enumerate(jmesh8.devices) for j, d in enumerate(row)}
    assert got[0][0]["encoder.layer.0.attention.self.query.weight"].shape == (32, 64)
    assert got[0][0]["encoder.layer.0.output.dense.weight"].shape == (64, 64)
    assert got[0][0]["embeddings.word_embeddings.weight"].shape == (128, 64)
    for dev, (i, j) in position.items():
        shard_tree = jax.tree.map(
            lambda leaf: next(np.asarray(s.data) for s in leaf.addressable_shards
                              if s.device == dev), placed)
        want = pml.from_jax_params(shard_tree)
        assert set(want) <= set(got[i][j])
        for name, w in want.items():
            np.testing.assert_array_equal(got[i][j][name].numpy(), w, err_msg=name)


# -- pipeline ---------------------------------------------------------------------------


def _layers(n: int, d: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.1).astype(np.float32)} for _ in range(n)]


def _jax_layer(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _port_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("n_layers,d,batch,n_micro,seed", [
    (4, 16, 16, 2, 0),  # 4 data replicas of 4 rows, 2 microbatches of 2
    (2, 8, 32, 4, 2),   # more microbatches
])
def test_pipeline_matches_jax_and_sequential(cpu8, jmesh8, n_layers, d, batch,
                                             n_micro, seed):
    layers = _layers(n_layers, d, seed)
    x = np.random.default_rng(seed + 1).standard_normal((batch, d)).astype(np.float32)
    want = np.asarray(jax_pipeline.pipeline_transformer_layers(
        jax.tree.map(jnp.asarray, layers), jnp.asarray(x), _jax_layer, jmesh8,
        n_micro=n_micro))
    port_layers = [{k: _t(v) for k, v in p.items()} for p in layers]
    got = pipeline.pipeline_transformer_layers(
        port_layers, _t(x), _port_layer, mesh.make_mesh(8, model_parallel=2),
        n_micro=n_micro).numpy()
    seq = _t(x)
    for p in port_layers:
        seq = _port_layer(p, seq)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, seq.numpy(), atol=1e-5)


def test_pipeline_apply_on_stacked_params(cpu8, jmesh8):
    """pipeline_apply over stacked [S, ...] leaves, a whole stage a block."""
    layers = _layers(2, 8, seed=4)
    x = np.random.default_rng(5).standard_normal((16, 8)).astype(np.float32)
    want = np.asarray(jax_pipeline.pipeline_apply(
        jax_pipeline.stack_stage_params(jax.tree.map(jnp.asarray, layers)),
        jnp.asarray(x), _jax_layer, jmesh8, n_micro=2))
    stacked = pipeline.stack_stage_params([{k: _t(v) for k, v in p.items()}
                                           for p in layers])
    got = pipeline.pipeline_apply(stacked, _t(x), _port_layer,
                                  mesh.make_mesh(8, model_parallel=2), n_micro=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("case", ["layers", "batch"])
def test_pipeline_rejects_what_jax_rejects(cpu8, jmesh8, case):
    n_layers, batch = (3, 8) if case == "layers" else (2, 10)
    layers = _layers(n_layers, 8)
    x = np.zeros((batch, 8), np.float32)
    with pytest.raises(ValueError) as want:
        jax_pipeline.pipeline_transformer_layers(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x), _jax_layer, jmesh8,
            n_micro=2)
    with pytest.raises(ValueError) as got:
        pipeline.pipeline_transformer_layers(
            [{k: _t(v) for k, v in p.items()} for p in layers], _t(x), _port_layer,
            mesh.make_mesh(8, model_parallel=2), n_micro=2)
    assert str(got.value) == str(want.value)


def test_stage_params_sharded_as_jax(cpu8, jmesh8):
    """Each entry holds only its stage's block (the memory win of PP)."""
    layers = _layers(2, 8)
    placed = jax_pipeline.shard_pipeline_params(
        jax_pipeline.stack_stage_params(jax.tree.map(jnp.asarray, layers)), jmesh8)
    got = pipeline.shard_pipeline_params(
        pipeline.stack_stage_params([{k: _t(v) for k, v in p.items()} for p in layers]),
        mesh.make_mesh(8, model_parallel=2))
    position = {d: (i, j) for i, row in enumerate(jmesh8.devices) for j, d in enumerate(row)}
    for s in placed["w"].addressable_shards:
        i, j = position[s.device]
        assert s.data.shape == (1,) + tuple(got[i][j]["w"].shape)
        np.testing.assert_array_equal(np.asarray(s.data)[0], got[i][j]["w"].numpy())
        np.testing.assert_array_equal(got[i][j]["w"].numpy(), layers[j]["w"])


# -- ring attention ---------------------------------------------------------------------


@pytest.mark.parametrize("axis,shape", [("data", (1, 2, 64, 16)),
                                        ("model", (2, 3, 40, 32))])
def test_ring_attention_matches_jax_and_full_attention(cpu8, jmesh8, axis, shape):
    rng = np.random.default_rng(0)
    q, k, v = ((rng.standard_normal(shape) * 0.3).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jmesh8, axis_name=axis))
    got = ring_attention(_t(q), _t(k), _t(v), mesh.make_mesh(8, model_parallel=2),
                         axis_name=axis)
    full = flash_attention_plain(_t(q), _t(k), _t(v))
    ref = np.asarray(_reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.full((shape[0],), shape[2], jnp.int32), False, shape[3] ** -0.5))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_ring_attention_scale_and_mask_value():
    from eioku_tpu.ops import ring_attention as jax_ring

    assert MASK_VALUE == jax_ring.MASK_VALUE
    rng = np.random.default_rng(3)
    q, k, v = (_t((rng.standard_normal((1, 2, 32, 16)) * 0.3).astype(np.float32))
               for _ in range(3))
    m = mesh.Mesh([[CPU], [CPU], [CPU], [CPU]])
    np.testing.assert_allclose(ring_attention(q, k, v, m, scale=0.1).numpy(),
                               flash_attention_plain(q, k, v, scale=0.1).numpy(), atol=2e-5)


# -- MoE --------------------------------------------------------------------------------


def _moe_case(seed: int, d: int = 16, ffn: int = 32, n_experts: int = 4, n: int = 32):
    jparams = jax_moe.init_moe_params(d=d, ffn=ffn, n_experts=n_experts, seed=seed)
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return jparams, moe.from_jax_params(jparams), x


@pytest.mark.parametrize("factor", [8.0, 1.25, 0.5])
def test_moe_matches_jax(factor):
    jparams, params, x = _moe_case(0)
    want = np.asarray(jax_moe.moe_ffn(jparams, jnp.asarray(x), capacity_factor=factor))
    got = moe.moe_ffn(params, _t(x), capacity_factor=factor).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if factor == 8.0:  # nothing drops: the per-token reference
        np.testing.assert_allclose(got, moe.moe_ffn_reference(params, _t(x)).numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(jax_moe.moe_ffn_reference(jparams, jnp.asarray(x))),
            rtol=1e-4, atol=1e-5)


def test_moe_drops_overflow_tokens_to_zero():
    """Every token routed to expert 0 with capacity 2 of 8: the first two
    keep their output, the rest give 0, as in the JAX package."""
    jparams = jax_moe.init_moe_params(d=8, ffn=16, n_experts=2, seed=1)
    jparams = jax_moe.MoeParams(jnp.zeros((8, 2)).at[:, 0].set(10.0), *jparams[1:])
    x = np.ones((8, 8), np.float32)
    want = np.asarray(jax_moe.moe_ffn(jparams, jnp.asarray(x), capacity_factor=0.5))
    got = moe.moe_ffn(moe.from_jax_params(jparams), _t(x), capacity_factor=0.5).numpy()
    nonzero = np.abs(got).sum(axis=1) > 1e-6
    assert nonzero.tolist() == [True, True] + [False] * 6
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_moe_sharded_matches_unsharded_and_jax(cpu8, jmesh8):
    """Two whole experts per entry of the model axis, the router on every
    entry: the same output as one device, and as the JAX package's
    sharded layer."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jparams, params, x = _moe_case(2)
    shards = moe.shard_moe_params(params, mesh.make_mesh(8, model_parallel=2))
    assert [s.w1.shape for s in shards] == [(2, 16, 32)] * 2
    assert all(torch.equal(s.router, params.router) for s in shards)
    got = moe.moe_ffn(shards, _t(x), capacity_factor=8.0).numpy()
    one = moe.moe_ffn(params, _t(x), capacity_factor=8.0).numpy()
    jsharded = jax_moe.shard_moe_params(jparams, jmesh8)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(jmesh8, P("data")))
    want = np.asarray(jax.jit(lambda p, v: jax_moe.moe_ffn(p, v, capacity_factor=8.0))(
        jsharded, xd))
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_init_moe_params_scheme():
    params = moe.init_moe_params(64, 128, 8, torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in params] == [(64, 8), (8, 64, 128), (8, 128),
                                                (8, 128, 64), (8, 64)]
    assert abs(float(params.router.std()) - 0.02) < 0.003
    assert abs(float(params.w1.std()) - (2 / 64) ** 0.5) < 0.01
    assert not params.b1.any() and not params.b2.any()
