"""The port's collectives across processes (backend b of
parallel/collectives.py) against the in-process backend (a), on the CPU.

Two worker processes join a gloo group through `initialize_distributed`,
from the variables a multi-host deployment sets (EIOKU_COORDINATOR on a
free localhost port, EIOKU_NUM_PROCESSES 2, EIOKU_PROCESS_ID, and
EIOKU_FORCE_CPU=1, which picks gloo), and run over `Mesh.over_process_group`:
psum, all_gather and ppermute; `whisper_encode_tp` and
`whisper_decode_windows_tp` at beam 1 and 2 on tiny Whisper (seeded
weights from the same torch.Generator on every side); ring attention.
Training (`run_training`) adds reduce_scatter and the autograd-aware
collectives (copy_to_line, reduce_from_line, all_gather) with their
gradients, the tensor-parallel fine-tune step over the model-axis group,
the data-parallel and FSDP steps over a data-axis group
(`Mesh.over_world`, `Mesh.over_process_group(axis="data")`), an FSDP
checkpoint that both ranks save and this process restores, and the
data-parallel detector over the group. This process runs the same calls
over meshes of two CPU entries. Tokens must be equal and inference tensors
within TOL (two-shard sums add the same two partials in either backend);
the training results within TRAIN_TOL (the first step's gradients
relative to each leaf's largest |value|), except the parameters of the
attention's key biases (held to KEY_BIAS_TOL: their gradient is zero in
exact arithmetic and fp32 noise that each backend sums in its own order,
which AdamW turns into steps of about lr either way;
tests/test_torch_fsdp.py). This process runs its side on one thread, as
the workers do, so that CPU kernels sum in the same order. The workers
are killed, and the test fails, if they have not finished within
WORKER_TIMEOUT_S.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from eioku_tpu_torch.parallel.collectives import LocalCollectives
from eioku_tpu_torch.parallel.mesh import Mesh

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 150
TOL = 1e-5
TRAIN_TOL = 1e-6
TRAIN_LR = 1e-3
KEY_BIAS_TOL = 2 * TRAIN_LR * 2 * 1.01  # two steps of about lr either way
BEAMS = (1, 2)

# The computation both backends run: `mesh` is the process-group mesh in a
# worker and a mesh of two CPU entries here; `comm` its model line.
CASES = r'''
import numpy as np
import torch

TRAIN_LR = 0.001

from eioku_tpu_torch.models.whisper.decoding import (
    build_suppress_masks, whisper_decode_windows_tp)
from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
from eioku_tpu_torch.models.whisper.model import (
    WhisperConfig, init_whisper, shard_whisper, whisper_encode_tp)
from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens
from eioku_tpu_torch.ops.ring_attention import ring_attention


def parts(rank):
    return torch.from_numpy(np.random.default_rng(10 + rank).standard_normal((3, 4))
                            .astype(np.float32))


def run(mesh, comm):
    out = {}
    xs = [parts(r) for r in comm.indices]
    for name, got in (("psum", comm.psum(xs)), ("all_gather", comm.all_gather(xs)),
                      ("ppermute", comm.ppermute(xs))):
        for r, t in zip(comm.indices, got):
            out[f"{name}_{r}"] = t.numpy()
    model = init_whisper(WhisperConfig("tiny"), torch.Generator().manual_seed(0)).eval()
    shards = shard_whisper(model, mesh)
    wav = np.random.default_rng(0).standard_normal((2, 4 * 16000)).astype(np.float32) * 0.1
    mel = log_mel_spectrogram(torch.from_numpy(wav), n_mels=80)[:, :, :200]
    enc = whisper_encode_tp(shards, mel)
    out["encode"] = enc.numpy()
    tk = WhisperTokens(51865)
    sot = torch.tensor([tk.sot_sequence("en")] * 2)
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    for beam in (1, 2):
        toks, lp, nsp = whisper_decode_windows_tp(shards, enc, sot, sup_a, sup_b,
                                                  max_len=12, beam_size=beam)
        out[f"tokens_{beam}"], out[f"lp_{beam}"], out[f"nsp_{beam}"] = (
            toks.numpy(), lp.numpy(), nsp.numpy())
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy((rng.standard_normal((1, 2, 32, 16)) * 0.3)
                                .astype(np.float32)) for _ in range(3))
    out["ring"] = ring_attention(q, k, v, mesh, axis_name="model").numpy()
    return out


def run_training(mesh, data_mesh, ckpt):
    """mesh: model axis 2; data_mesh: data axis 2; ckpt: a directory for
    the FSDP checkpoint."""
    import torch.distributed.nn.functional as dist_nn

    from eioku_tpu_torch.models.checkpoint import save_sharded
    from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, init_minilm
    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
    from eioku_tpu_torch.parallel.fsdp import gather_tree, make_fsdp_train_step
    from eioku_tpu_torch.parallel.fsdp import gradients as fsdp_gradients
    from eioku_tpu_torch.parallel.inference import DataParallelDetector
    from eioku_tpu_torch.parallel.train import adamw, make_train_step

    out = {}
    comm, dcomm = mesh.lines("model")[0], data_mesh.lines("data")[0]
    xs = [parts(r) for r in comm.indices]
    for r, t in zip(comm.indices, comm.reduce_scatter([torch.cat([x, x]) for x in xs], dim=0)):
        out[f"reduce_scatter_{r}"] = t.numpy()
    # the Megatron pair under one loss: d/dx of sum_r (r + 1) x summed = 3
    x = torch.ones(3, 4, requires_grad=True)
    ins = comm.copy_to_line([x] * len(comm.indices))
    ys = [t * (r + 1) for r, t in zip(comm.indices, ins)]
    sums = comm.reduce_from_line(ys)
    (sums[0] * torch.arange(12.0).reshape(3, 4)).sum().backward()
    out["megatron_sum"], out["megatron_grad"] = sums[0].detach().numpy(), x.grad.numpy()
    if torch.distributed.is_initialized():  # the trap: all-reduce in backward too
        x2 = torch.ones(3, 4, requires_grad=True)
        (in2,) = comm.copy_to_line([x2])
        y2 = dist_nn.all_reduce(in2 * (comm.indices[0] + 1))
        (y2 * torch.arange(12.0).reshape(3, 4)).sum().backward()
        out["trap_grad"] = x2.grad.numpy()
    ps = [(parts(r)[:1] * 0 + r + 1).requires_grad_(True) for r in comm.indices]
    full = comm.all_gather(ps, dim=0)
    sum(((f * (r + 1)) ** 2).sum() for r, f in zip(comm.indices, full)).backward()
    for r, p in zip(comm.indices, ps):
        out[f"gather_full_{r}"] = full[0].detach().numpy()
        out[f"gather_grad_{r}"] = p.grad.numpy()
    cfg = MiniLMConfig(vocab_size=128, dim=32, n_layers=2, n_heads=4, ffn_dim=64,
                       max_position=32)
    base = init_minilm(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        base.embeddings.word_embeddings.weight.mul_(100)
    rng = np.random.default_rng(5)
    batch = [torch.from_numpy(rng.integers(0, 128, (8, 16))), torch.ones(8, 16, dtype=torch.int64),
             torch.from_numpy(rng.integers(0, 128, (8, 16))), torch.ones(8, 16, dtype=torch.int64)]
    batch[1][2, 9:] = 0
    for name, m in (("tp", mesh), ("dp", data_mesh)):
        step, _ = make_train_step(base, lambda p: adamw(p, TRAIN_LR), m)
        losses = [float(step(*batch))]
        for k, v in step.gradients().items():
            out[f"{name}_grad/{k}"] = v.numpy()
        losses.append(float(step(*batch)))
        out[f"{name}_loss"] = np.array(losses)
        for k, v in step.state_dict().items():
            out[f"{name}/{k}"] = v.numpy()
    fstep, _, prepare = make_fsdp_train_step(base, data_mesh, lambda p: adamw(p, TRAIN_LR))
    params, state = prepare(base)
    losses = []
    for i in range(2):
        params, state, loss = fstep(params, state, *batch)
        losses.append(float(loss))
        if i == 0:
            for k, v in fsdp_gradients(params).items():
                out[f"fsdp_grad/{k}"] = v.numpy()
    out["fsdp_loss"] = np.array(losses)
    save_sharded({"params": params, "opt": state}, ckpt)
    whole = gather_tree({"params": params, "opt": state})
    for k, v in whole["params"].items():
        out[f"fsdp/{k}"] = v.numpy()
    for k, v in whole["opt"]["exp_avg_sq"].items():
        out[f"fsdp_v/{k}"] = v.numpy()
    det = fold_batchnorm(YOLOv8(YoloConfig("yolov8n", num_classes=4),
                                generator=torch.Generator().manual_seed(0))).eval()
    frames = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (3, 64, 96, 3), dtype=np.uint8))
    for k, v in DataParallelDetector(det, data_mesh)(frames, conf_threshold=0.0,
                                                      top_k=32).items():
        out[f"detect_{k}"] = v.numpy()
    return out
'''

WORKER = r'''
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from eioku_tpu_torch.parallel.mesh import Mesh, initialize_distributed

assert initialize_distributed() is True
assert initialize_distributed() is True  # idempotent
assert torch.distributed.get_backend() == "gloo"
mesh = Mesh.over_process_group("cpu")
data_mesh = Mesh.over_world("cpu")
assert data_mesh.shape == Mesh.over_process_group("cpu", axis="data").shape \
    == {"data": 2, "model": 1}
assert Mesh.over_world("cpu", model_parallel=2).shape == mesh.shape == {"data": 1, "model": 2}
ns = {}
exec(open(sys.argv[1]).read(), ns)
out = ns["run"](mesh, mesh.lines("model")[0])
out.update(ns["run_training"](mesh, data_mesh, os.path.join(sys.argv[2], "ckpt")))
np.savez(os.path.join(sys.argv[2], f"rank{torch.distributed.get_rank()}.npz"), **out)
torch.distributed.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """(each rank's outputs over two gloo processes, this process's over
    [cpu, cpu])."""
    d = tmp_path_factory.mktemp("torch_distributed")
    (d / "cases.py").write_text(CASES)
    (d / "worker.py").write_text(WORKER)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "EIOKU_FORCE_CPU": "1",
               "EIOKU_COORDINATOR": f"127.0.0.1:{port}", "EIOKU_NUM_PROCESSES": "2",
               "EIOKU_PROCESS_ID": str(rank), "OMP_NUM_THREADS": "1"}
        log = open(d / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(d / "worker.py"), str(d / "cases.py"), str(d)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"gloo workers still running after {WORKER_TIMEOUT_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    codes = [p.returncode for p, _ in procs]
    assert codes == [0, 0], (codes, [(d / f"rank{r}.log").read_text()[-3000:]
                                     for r in range(2)])
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    ns = {}
    exec(CASES, ns)
    local = Mesh([["cpu", "cpu"]])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' count: CPU kernels sum in their order
    try:
        here = ns["run"](local, local.lines("model")[0])
        here.update(ns["run_training"](local, Mesh([["cpu"], ["cpu"]]),
                                       str(d / "ckpt_here")))
    finally:
        torch.set_num_threads(threads)
    here["ckpt_dir"] = str(d / "ckpt")  # the one the two ranks saved
    return ranks, here


@pytest.mark.parametrize("name", ["psum", "all_gather", "ppermute"])
def test_collectives_match_in_process(backends, name):
    ranks, here = backends
    for r in range(2):
        np.testing.assert_allclose(ranks[r][f"{name}_{r}"], here[f"{name}_{r}"],
                                   rtol=0, atol=TOL)


def test_collectives_by_definition():
    """Backend (a) itself: the sum, the concatenation and the rotation."""
    xs = [torch.arange(4.0).reshape(2, 2) + 10 * i for i in range(3)]
    comm = LocalCollectives(["cpu"] * 3)
    assert all(torch.equal(t, xs[0] + xs[1] + xs[2]) for t in comm.psum(xs))
    assert all(torch.equal(t, torch.cat(xs, dim=-1)) for t in comm.all_gather(xs))
    assert [float(t[0, 0]) for t in comm.ppermute(xs)] == [20.0, 0.0, 10.0]


def test_encode_tp_matches_in_process(backends):
    ranks, here = backends
    for out in ranks:
        assert out["encode"].shape == (2, 100, 384)
        np.testing.assert_allclose(out["encode"], here["encode"], rtol=0, atol=TOL)


@pytest.mark.parametrize("beam", BEAMS)
def test_decode_tp_matches_in_process(backends, beam):
    ranks, here = backends
    for out in ranks:
        np.testing.assert_array_equal(out[f"tokens_{beam}"], here[f"tokens_{beam}"])
        for key in (f"lp_{beam}", f"nsp_{beam}"):
            np.testing.assert_allclose(out[key], here[key], rtol=0, atol=TOL)


def test_ring_attention_matches_in_process(backends):
    ranks, here = backends
    for out in ranks:
        np.testing.assert_allclose(out["ring"], here["ring"], rtol=0, atol=TOL)


def test_process_group_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        Mesh.over_process_group("cpu")



# -- training ---------------------------------------------------------------------------------


def _train_close(got, want, name: str) -> None:
    tol = KEY_BIAS_TOL if name.endswith("attention.self.key.bias") else TRAIN_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def test_reduce_scatter_matches_in_process(backends):
    """Each rank's piece of the summed [x_r, x_r] is the psum of the x_r."""
    ranks, here = backends
    for r in range(2):
        np.testing.assert_allclose(ranks[r][f"reduce_scatter_{r}"],
                                   here[f"reduce_scatter_{r}"], rtol=0, atol=TRAIN_TOL)
        np.testing.assert_allclose(ranks[r][f"reduce_scatter_{r}"], ranks[r][f"psum_{r}"],
                                   rtol=0, atol=TRAIN_TOL)


def test_autograd_collectives_match_in_process_and_the_definition(backends):
    """copy_to_line / reduce_from_line: the sum, and a gradient of 1 + 2 =
    3 on x, where torch.distributed.nn's all_reduce gives tp times that;
    all_gather: each part's gradient is its slice of the summed gradient."""
    ranks, here = backends
    weights = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    for out in (*ranks, here):
        np.testing.assert_allclose(out["megatron_sum"], np.full((3, 4), 3.0))
        np.testing.assert_allclose(out["megatron_grad"], 3 * weights)
        for k in [k for k in out if k.startswith("gather_full_")]:
            np.testing.assert_allclose(out[k], [[1.0] * 4, [2.0] * 4])
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["trap_grad"], 2 * out["megatron_grad"])
        # d/dp_r of sum_k ((k + 1) full)^2 = sum_k 2 (k + 1)^2 p_r
        np.testing.assert_allclose(out[f"gather_grad_{r}"], here[f"gather_grad_{r}"],
                                   rtol=0, atol=TRAIN_TOL)
        np.testing.assert_allclose(out[f"gather_grad_{r}"], np.full((1, 4), 10.0 * (r + 1)))


@pytest.mark.parametrize("name", ["tp", "dp", "fsdp"])
def test_training_steps_match_in_process(backends, name):
    """The losses, the first step's gradients (within TRAIN_TOL of each
    leaf's largest |value|; a key bias's scale is its layer's query
    bias's) and the parameters after two steps."""
    ranks, here = backends
    for out in ranks:
        np.testing.assert_allclose(out[f"{name}_loss"], here[f"{name}_loss"], rtol=0,
                                   atol=TRAIN_TOL)
        keys = [k for k in here if k.startswith(f"{name}/")]
        assert len(keys) == 2 * 16 + 5 and set(keys) <= set(out)
        for k in keys:
            _train_close(out[k], here[k], k)
            g = k.replace(f"{name}/", f"{name}_grad/")
            scale = np.abs(here[g.replace("key.bias", "query.bias")]).max()
            np.testing.assert_allclose(out[g], here[g], rtol=0, atol=TRAIN_TOL * scale,
                                       err_msg=g)


def test_checkpoint_saved_by_two_ranks_restores_here(backends, tmp_path_factory):
    """The FSDP state both ranks saved, restored in this process into two
    CPU entries and into whole tensors: the ranks' own values, bit for bit."""
    from eioku_tpu_torch.models.checkpoint import restore_sharded
    from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, init_minilm
    from eioku_tpu_torch.parallel.fsdp import gather_tree, make_fsdp_train_step

    ranks, here = backends
    ckpt = pathlib.Path(here["ckpt_dir"])
    assert (ckpt / "metadata.json").is_file() and not ckpt.with_suffix(".tmp").exists()
    cfg = MiniLMConfig(vocab_size=128, dim=32, n_layers=2, n_heads=4, ffn_dim=64,
                       max_position=32)
    model = init_minilm(cfg, torch.Generator().manual_seed(2))
    _, _, prepare = make_fsdp_train_step(model, Mesh([["cpu"], ["cpu"]]))
    params, state = prepare(model)
    for template in ({"params": params, "opt": state},
                     gather_tree({"params": params, "opt": state})):
        back = gather_tree(restore_sharded(template, str(ckpt)))
        assert float(back["opt"]["step"]) == 2
        for k, v in back["params"].items():
            np.testing.assert_array_equal(v.numpy(), ranks[0][f"fsdp/{k}"], err_msg=k)
            np.testing.assert_array_equal(v.numpy(), ranks[1][f"fsdp/{k}"], err_msg=k)
        for k, v in back["opt"]["exp_avg_sq"].items():
            np.testing.assert_array_equal(v.numpy(), ranks[0][f"fsdp_v/{k}"], err_msg=k)


def test_data_parallel_detect_matches_in_process(backends):
    """Each rank detects its share of 3 frames (padded to 4) and returns
    the whole batch's keep masks, classes, boxes and scores."""
    ranks, here = backends
    for out in ranks:
        for k in ("valid", "classes"):
            np.testing.assert_array_equal(out[f"detect_{k}"], here[f"detect_{k}"])
        assert out["detect_boxes"].shape[0] == 3
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(out[f"detect_{k}"], here[f"detect_{k}"], rtol=0,
                                       atol=TRAIN_TOL)
