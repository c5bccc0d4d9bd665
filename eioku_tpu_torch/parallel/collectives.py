"""The collectives that the port's parallel functions are written against.

The JAX package is single-controller: one process drives a mesh, and
`shard_map` bodies move data with `psum`, `all_gather` and `ppermute`. The
port writes each parallel function once, over the local shards of one line
of its mesh (parallel/mesh.py): every step is computed for each local
shard, in order, and these operations combine the per-shard tensors, one
list entry per local shard. Two backends give the same results:

- `LocalCollectives` (backend a): every shard of the line lives in this
  process, shard i on devices[i], and the same device may be listed more
  than once (one card then runs the shards one after the other). psum adds
  the partials on the first shard's device in shard order and copies the
  sum back to each device; all_gather concatenates there; ppermute copies
  each part to the next device on the ring. A copy to the device a tensor
  is already on is no copy, so shards on one device share the result:
  callers never write into what a collective returns.
- `ProcessCollectives` (backend b): one shard per process, over a
  `torch.distributed` group (NCCL on the card, gloo on the CPU):
  `all_reduce`, `all_gather_into_tensor`, `reduce_scatter_tensor`, and
  `batch_isend_irecv` for the ring.

Training adds the Megatron pair, `copy_to_line` (identity forward, psum
backward) and `reduce_from_line` (psum forward, identity backward), and
an `all_gather` whose backward hands each shard its slice of the summed
gradient (a reduce-scatter). A line's loss counts once: in backend (a)
the caller takes it from the first local shard, and autograd through
`.to()`, `+` and `cat` already gives every leaf its gradient (the two
Megatron forms are then the identity and `psum`); in backend (b) every
rank computes the same loss, so the forms are `torch.autograd.Function`s.
(`torch.distributed.nn.functional.all_reduce` would all-reduce in
backward as well and multiply the gradients by the line's size.)

A shard's work runs under `on(device)`, because the hand-written kernels
(K3 in the Whisper encoder) launch on the current device's stream.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def on(device: torch.device):
    """The device context a shard's work runs under."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class LocalCollectives:
    """Backend (a): all `len(devices)` shards of a line in this process."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices")
        self.size = len(self.devices)
        self.indices = list(range(self.size))  # each local shard's index on the line

    def psum(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        home = parts[0].device
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(home)
        return [total.to(d) for d in self.devices]

    def all_gather(self, parts: list[torch.Tensor], dim: int = -1) -> list[torch.Tensor]:
        home = parts[0].device
        full = torch.cat([p.to(home) for p in parts], dim=dim)
        return [full.to(d) for d in self.devices]

    def ppermute(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shard i's part goes to shard (i + 1) % size."""
        n = self.size
        return [parts[(i - 1) % n].to(self.devices[i]) for i in range(n)]

    def reduce_scatter(self, parts: list[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
        """The sum of the parts, cut in `size` equal pieces along `dim`:
        shard i keeps piece i."""
        total = self.psum(parts)[0]
        if total.shape[dim] % self.size:
            raise ValueError(f"dimension {dim} of {tuple(total.shape)} does not divide "
                             f"by {self.size}")
        k = total.shape[dim] // self.size
        return [total.narrow(dim, i * k, k).to(d) for i, d in enumerate(self.devices)]

    def copy_to_line(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Megatron's f: each shard's input as it is (the gradients of its
        uses meet in the input's one autograd node)."""
        return list(parts)

    def reduce_from_line(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Megatron's g: the psum (the first shard's use carries the loss)."""
        return self.psum(parts)


class ProcessCollectives:
    """Backend (b): this process's one shard of a line whose shards are the
    ranks of `group` (None: the default group)."""

    def __init__(self, device, group=None):
        self.group = group
        self.devices = [torch.device(device)]
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.indices = [self.rank]

    def _global(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def psum(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        (p,) = parts
        return [_all_reduce(p, self.group)]

    def all_gather(self, parts: list[torch.Tensor], dim: int = -1) -> list[torch.Tensor]:
        """The parts concatenated along `dim`; backward: each rank's slice
        of the summed gradient."""
        (p,) = parts
        return [_AllGather.apply(p, self.group, self.size, dim)]

    def reduce_scatter(self, parts: list[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
        (p,) = parts
        return [_reduce_scatter(p, self.group, self.size, dim)]

    def copy_to_line(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        (p,) = parts
        return [_CopyToLine.apply(p, self.group)]

    def reduce_from_line(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        (p,) = parts
        return [_ReduceFromLine.apply(p, self.group)]

    def ppermute(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """This rank's part goes to rank + 1, and rank - 1's comes in."""
        (p,) = parts
        if self.size == 1:
            return [p]
        p = p.contiguous()
        out = torch.empty_like(p)
        ops = [dist.P2POp(dist.isend, p, self._global((self.rank + 1) % self.size), self.group),
               dist.P2POp(dist.irecv, out, self._global((self.rank - 1) % self.size), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [out]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.clone()  # all_reduce sums in place
    dist.all_reduce(out, group=group)
    return out


def _all_gather(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    t = t.movedim(dim, 0).contiguous()  # all_gather_into_tensor stacks on dim 0
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    t = t.movedim(dim, 0).contiguous()
    if t.shape[0] % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide by {size}")
    out = t.new_empty((t.shape[0] // size,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=group)
    return out.movedim(0, dim)


class _CopyToLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.size, ctx.dim), None, None, None
