"""Device mesh, sharding policies and the process group (port of
eioku_tpu/parallel/mesh.py).

The JAX package keeps one 2-D ("data", "model") mesh per process: batches
shard over "data", the transformer families split Megatron-style over
"model" (column/row pairs), and XLA inserts the all-reduces. The port's
`Mesh` is the same grid of `torch.device`s, in one process; a device may
appear more than once (`[cuda:0, cuda:0]` runs two shards one after the
other on one card). Its lines along an axis come with the collectives
(parallel/collectives.py) that the parallel functions are written against.
`Mesh.over_process_group` and `Mesh.over_world` are the same mesh across
processes: an axis spans the ranks of a `torch.distributed` group, one
device each, and this process holds its rank's entry.

The device list comes from `local_devices` alone, which tests and smoke
runs replace to stand a list such as `[cpu] * 8` or `[cuda:0, cuda:0]` in
for the host's cards.

Placing a tensor or a model on the mesh returns the grid of what each entry
holds (`grid[i][j]` for mesh entry (i, j)); entries that repeat a device and
hold the same shard share one copy. A `ShardedTensor` is one tensor laid
out over a line of the mesh (FSDP's parameters and optimizer moments,
parallel/fsdp.py; sharded checkpoints, models/checkpoint.py).
"""
from __future__ import annotations

import copy
import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch import nn

from eioku_tpu_torch.parallel.collectives import LocalCollectives, ProcessCollectives
from eioku_tpu_torch.utils.device import entry_point_device, resolve_device

AXES = ("data", "model")
DIST_TIMEOUT_S = 300.0  # init_process_group's timeout, and its collectives'


def local_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """The devices a mesh may span: every visible card (None or a CUDA
    device; raises on a host without CUDA), or the CPU when asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A (data, model) grid of devices: `devices[i][j]` is the entry at
    data index i and model index j. Over processes (`groups`: an axis ->
    the `torch.distributed` group whose ranks it spans) the grid holds this
    process's one entry."""

    axis_names = AXES

    def __init__(self, devices, groups: dict | None = None):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or \
                len({len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.groups = dict(groups or {})
        if set(self.groups) - set(AXES) or \
                (self.groups and len(self.devices) * len(self.devices[0]) != 1):
            raise ValueError("a mesh over processes holds one entry, its groups "
                             f"span axes of {AXES}")

    @classmethod
    def over_process_group(cls, device: str | torch.device, group=None,
                           axis: str = "model") -> Mesh:
        """`axis` over the ranks of `group` (None: the default group, which
        must be initialised), the other axis of size 1; this process's
        entry on `device`."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; have {AXES}")
        if not dist.is_initialized():
            raise RuntimeError("no process group; call initialize_distributed first")
        return cls([[device]], {axis: group or dist.group.WORLD})

    @classmethod
    def over_world(cls, device: str | torch.device, model_parallel: int = 1) -> Mesh:
        """`make_mesh` over the ranks of the default group: rank r is entry
        (r // model_parallel, r % model_parallel) of a (world /
        model_parallel, model_parallel) grid. The data axis always spans a
        group (of one rank at world size 1), the model axis one when
        model_parallel > 1; every rank creates every line's group, in one
        order, as `dist.new_group` requires."""
        if not dist.is_initialized():
            raise RuntimeError("no process group; call initialize_distributed first")
        n, rank, mp = dist.get_world_size(), dist.get_rank(), model_parallel
        if n % mp != 0:
            raise ValueError("n_devices must be divisible by model_parallel")

        def line(ranks: list[int]):
            return dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)
        groups = {}
        for j in range(mp):  # data lines: the ranks of model index j
            g = line(list(range(j, n, mp)))
            if rank % mp == j:
                groups["data"] = g
        if mp > 1:
            for i in range(n // mp):  # model lines: the ranks of data index i
                g = line(list(range(i * mp, (i + 1) * mp)))
                if rank // mp == i:
                    groups["model"] = g
        return cls([[device]], groups)

    @property
    def shape(self) -> dict[str, int]:
        local = {"data": len(self.devices), "model": len(self.devices[0])}
        return {axis: dist.get_world_size(self.groups[axis]) if axis in self.groups
                else local[axis] for axis in AXES}

    def lines(self, axis: str = "model") -> list:
        """The mesh's lines along `axis`, in order of the other axis' index,
        each as its collectives (with the devices of its local shards)."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; have {AXES}")
        if axis in self.groups:
            return [ProcessCollectives(self.devices[0][0], self.groups[axis])]
        rows = self.devices if axis == "model" else [list(c) for c in zip(*self.devices)]
        return [LocalCollectives(row) for row in rows]

    def place(self, make, axis: str = "model") -> list[list]:
        """grid[i][j] = make(index of entry (i, j) on `axis`, its device),
        made once for each (index, device) pair."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; have {AXES}")
        made = {}

        def entry(index: int, dev: torch.device):
            if (index, dev) not in made:
                made[index, dev] = make(index, dev)
            return made[index, dev]
        if self.groups:
            index = dist.get_rank(self.groups[axis]) if axis in self.groups else 0
            return [[entry(index, self.devices[0][0])]]
        return [[entry(j if axis == "model" else i, d) for j, d in enumerate(row)]
                for i, row in enumerate(self.devices)]

    @staticmethod
    def line_entries(grid: list[list], axis: str = "model") -> list[list]:
        """A `place` grid regrouped by the lines of `lines(axis)`: what each
        line's local shards hold, in the line's order."""
        return grid if axis == "model" else [list(col) for col in zip(*grid)]


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """2-D mesh (data, model) over the first n_devices of `local_devices`."""
    devices = local_devices(device)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n % model_parallel != 0:
        raise ValueError("n_devices must be divisible by model_parallel")
    return Mesh([devices[i:i + model_parallel] for i in range(0, n, model_parallel)])


def shard_slice(t: torch.Tensor, dim: int | None, index: int, n: int) -> torch.Tensor:
    """Shard `index` of `n` equal parts of t along `dim` (None: all of t),
    as a view."""
    if dim is None:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide by {n}")
    k = t.shape[dim] // n
    return t.narrow(dim, index * k, k)


def tree_map(fn, *trees):
    """fn over the leaves of equally shaped dict / list / tuple trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a dict / list / tuple tree, in `tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


class ShardedTensor:
    """A tensor of `shape` laid out over one line of a mesh (`line`, its
    collectives): cut in `line.size` equal parts along `dim`, or whole on
    every entry (dim None). `parts[k]` is what the line's k-th local shard
    holds (part `line.indices[k]`, on `line.devices[k]`); entries on one
    device share a whole tensor."""

    def __init__(self, shape, dim: int | None, line, parts: list[torch.Tensor]):
        self.shape, self.dim, self.line, self.parts = tuple(shape), dim, line, list(parts)

    @classmethod
    def cut(cls, t: torch.Tensor, dim: int | None, line) -> ShardedTensor:
        """t's parts, copied onto the line's local devices (a whole tensor
        once per device)."""
        made: dict = {}

        def part(index: int, dev: torch.device) -> torch.Tensor:
            key = (None if dim is None else index, dev)
            if key not in made:
                made[key] = shard_slice(t, dim, index, line.size).to(
                    dev, copy=True, memory_format=torch.contiguous_format)
            return made[key]
        return cls(t.shape, dim, line, [part(i, d) for i, d in zip(line.indices, line.devices)])

    @property
    def n(self) -> int:
        """The number of parts (1 when whole)."""
        return 1 if self.dim is None else self.line.size

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def unique_parts(self) -> list[torch.Tensor]:
        return list({id(p): p for p in self.parts}.values())

    def map(self, fn) -> ShardedTensor:
        """fn of each distinct part, in the same layout."""
        done = {id(p): fn(p) for p in self.unique_parts()}
        return ShardedTensor(self.shape, self.dim, self.line, [done[id(p)] for p in self.parts])

    def on_entries(self) -> list[torch.Tensor]:
        """The whole tensor on each local shard's device: the parts
        gathered over the line (differentiable: each part's gradient is
        its slice of the summed gradient)."""
        if self.dim is None:
            return self.parts
        return self.line.all_gather(self.parts, dim=self.dim)

    def full(self) -> torch.Tensor:
        """The whole tensor, on the first local shard's device."""
        return self.on_entries()[0]


def replicated(mesh: Mesh, x: torch.Tensor) -> list[list[torch.Tensor]]:
    """x on every entry of the mesh."""
    return mesh.place(lambda index, dev: x.to(dev))


def data_sharded(mesh: Mesh, x: torch.Tensor) -> list[list[torch.Tensor]]:
    """The batch dimension of x split over the data axis (inputs,
    activations): every entry of data row i holds the i-th part."""
    n = mesh.shape["data"]
    return mesh.place(lambda index, dev: shard_slice(x, 0, index, n).to(dev), axis="data")


def shard_yolo_params(model: nn.Module, mesh: Mesh) -> list[list[nn.Module]]:
    """YOLO is pure data parallel: a replica on every device (the model
    itself where it lies). Conv channel counts in the small variants do not
    amortise tensor-parallel collectives; throughput scales with the frame
    batch."""
    home = next(model.parameters()).device
    return mesh.place(lambda index, dev: model if dev == home
                      else copy.deepcopy(model).to(dev))


def _minilm_dim(name: str) -> int | None:
    """Megatron TP for the transformer, on the port's (HF) parameter names
    in torch's [out, in] layout: q/k/v/ffn1 split the output dim (column),
    o/ffn2 split the input dim (row), the token embedding splits the
    vocabulary; everything else (the o/ffn2 biases too) replicates. The
    JAX package's `_minilm_spec` on its names."""
    if name.endswith(("query.weight", "key.weight", "value.weight",
                      "intermediate.dense.weight", "query.bias", "key.bias",
                      "value.bias", "intermediate.dense.bias")):
        return 0
    if name.endswith("output.dense.weight"):  # attention.output.dense (o), output.dense (ffn2)
        return 1
    if name == "embeddings.word_embeddings.weight":
        return 0
    return None


def shard_minilm_params(model: nn.Module, mesh: Mesh) -> list[list[dict[str, torch.Tensor]]]:
    """Each entry's state dict of MiniLM's Megatron shard (`_minilm_dim`)
    along the model axis, on its device."""
    state = model.state_dict()
    tp = mesh.shape["model"]
    return mesh.place(lambda index, dev: {
        name: shard_slice(t, _minilm_dim(name), index, tp).to(dev)
        for name, t in state.items()})


_distributed_initialized = False


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device: str | torch.device | None = None) -> bool:
    """Multi-host start-up: one process per host, the control plane stays
    the job queue.

    Reads EIOKU_COORDINATOR (host:port) / EIOKU_NUM_PROCESSES /
    EIOKU_PROCESS_ID when arguments are omitted. Returns True when a
    process group was initialised (or already was), False for the
    single-host no-op (no coordinator configured). The backend is NCCL on
    a CUDA host; gloo only when the caller asks for the CPU (device "cpu",
    or EIOKU_FORCE_CPU=1). A host without CUDA that did not ask for the
    CPU raises; there is no fallback from NCCL to gloo.
    """
    global _distributed_initialized
    if _distributed_initialized:
        return True
    coordinator = coordinator or os.environ.get("EIOKU_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("EIOKU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("EIOKU_PROCESS_ID", "0"))
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes}")
    dev = resolve_device(device if device is not None
                         else entry_point_device(needs_card=False))
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=DIST_TIMEOUT_S))
    _distributed_initialized = True
    return True
