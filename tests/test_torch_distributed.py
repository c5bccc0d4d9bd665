"""The port's collectives across processes (backend b of
parallel/collectives.py) against the in-process backend (a), on the CPU.

Two worker processes join a gloo group through `initialize_distributed`,
from the variables a multi-host deployment sets (EIOKU_COORDINATOR on a
free localhost port, EIOKU_NUM_PROCESSES 2, EIOKU_PROCESS_ID, and
EIOKU_FORCE_CPU=1, which picks gloo), and run over `Mesh.over_process_group`:
psum, all_gather and ppermute; `whisper_encode_tp` and
`whisper_decode_windows_tp` at beam 1 and 2 on tiny Whisper (seeded
weights from the same torch.Generator on every side); ring attention. This
process runs the same calls over a mesh of two CPU entries. Tokens must be
equal and tensors within 1e-5 (two-shard sums add the same two partials
in either backend). The workers are killed, and the test fails, if they
have not finished within WORKER_TIMEOUT_S.
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
BEAMS = (1, 2)

# The computation both backends run: `mesh` is the process-group mesh in a
# worker and a mesh of two CPU entries here; `comm` its model line.
CASES = r'''
import numpy as np
import torch

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
ns = {}
exec(open(sys.argv[1]).read(), ns)
out = ns["run"](mesh, mesh.lines("model")[0])
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
    return ranks, ns["run"](local, local.lines("model")[0])


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

