"""Pipeline parallelism: GPipe-style microbatch rotation over a mesh axis
(port of eioku_tpu/parallel/pipeline.py).

Consecutive layer blocks live on consecutive entries of the mesh's `model`
axis, activations flow stage to stage through `ppermute`
(parallel/collectives.py), and the batch is cut into microbatches so that
every stage is busy once the pipeline fills (bubble (S-1)/(S-1+M) of the
schedule). Stage blocks map an activation to one of the same shape: the
transformer trunks this framework serves.

The schedule is the JAX package's: S + M - 1 ticks; at tick t stage 0
ingests microbatch t, every stage runs its block on what it holds, the last
stage stores microbatch t - (S - 1), and the activations rotate one stage
forward. The JAX program computes every stage at every tick and throws the
fill and drain ticks' outputs away; the port skips them (a stage with no
microbatch at tick t passes on what it holds, which its successor does not
read). The last stage's outputs reach every stage by a psum in which the
other stages add zeros, as in the JAX package.

The JAX package stacks parameters into [S, ...] leaves for its `lax.scan`;
the port keeps that layout for `stack_stage_params` and
`shard_pipeline_params`, and `pipeline_transformer_layers` hands each stage
its own list of layers (a Python loop is the port's scan).
"""
from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from eioku_tpu_torch.parallel.collectives import on
from eioku_tpu_torch.parallel.mesh import Mesh, tree_map


def stack_stage_params(per_stage_params: list):
    """Stack S per-stage trees into one tree with leading [S, ...] leaves
    (the layout `shard_pipeline_params` splits over the stages)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def shard_pipeline_params(stacked_params, mesh: Mesh, axis: str = "model") -> list[list]:
    """Each mesh entry's stage block of stacked [S, ...] params (S =
    mesh.shape[axis]), on its device: entry (i, j) holds block j of the
    model axis (block i of the data axis)."""
    n = mesh.shape[axis]

    def block(index: int, dev: torch.device):
        def leaf(t: torch.Tensor) -> torch.Tensor:
            if t.shape[0] != n:
                raise ValueError(f"a leaf of {t.shape[0]} stages on a {n}-stage axis")
            return t[index].to(dev)
        return tree_map(leaf, stacked_params)
    return mesh.place(block, axis)


def _place(params, dev: torch.device):
    """A stage's params on its device: a module not already there is
    copied, a tensor tree moved."""
    if isinstance(params, nn.Module):
        home = next(params.parameters()).device
        return params if home == dev else copy.deepcopy(params).to(dev)
    return tree_map(lambda t: t.to(dev), params)


def pipeline_apply(stacked_params, x: torch.Tensor, stage_fn: Callable, mesh: Mesh,
                   n_micro: int | None = None, axis: str = "model") -> torch.Tensor:
    """Run x through the S stages of `axis` (S = mesh.shape[axis]).

    stacked_params: a tree with leading [S, ...] leaves (`stack_stage_params`);
      each entry gets its stage's block (`shard_pipeline_params`).
    x: [batch, ...]; the batch splits over the mesh's other axis (each of
      its lines runs its own pipeline) and each part into n_micro
      microbatches (default 2 S).
    stage_fn(block, microbatch) -> microbatch of the same shape.
    Returns the outputs in x's batch order, on x's device."""
    return _pipeline(shard_pipeline_params(stacked_params, mesh, axis), x, stage_fn,
                     mesh, n_micro, axis)


def _pipeline(blocks: list[list], x: torch.Tensor, stage_fn: Callable, mesh: Mesh,
              n_micro: int | None, axis: str) -> torch.Tensor:
    """pipeline_apply over the grid of each entry's block."""
    n_stages = mesh.shape[axis]
    if n_micro is None:
        n_micro = max(2 * n_stages, 1)  # keep the fill/drain bubble modest
    lines = mesh.lines(axis)
    n_data = len(lines)
    if x.shape[0] % (n_data * n_micro) != 0:
        raise ValueError(
            f"batch {x.shape[0]} must divide by data shards ({n_data}) x "
            f"microbatches ({n_micro})")
    per_line = x.shape[0] // n_data
    outs = []
    for li, (comm, line_blocks) in enumerate(zip(lines, mesh.line_entries(blocks, axis))):
        xb = x[li * per_line:(li + 1) * per_line]
        outs.append(_pipeline_line(line_blocks, xb, stage_fn, comm, n_stages, n_micro))
    return torch.cat([o.to(x.device) for o in outs])


def _pipeline_line(blocks: list, xb: torch.Tensor, stage_fn: Callable, comm,
                   n_stages: int, n_micro: int) -> torch.Tensor:
    """One line's GPipe schedule over its local stages (all of them in one
    process, or this rank's over a process group)."""
    m = xb.shape[0] // n_micro
    micro = xb.reshape((n_micro, m) + tuple(xb.shape[1:]))
    bufs = [torch.zeros_like(micro[0], device=d) for d in comm.devices]
    stored = [[] for _ in comm.devices]
    for t in range(n_micro + n_stages - 1):
        ys = []
        for k, (stage, dev, block) in enumerate(zip(comm.indices, comm.devices, blocks)):
            mb = t - stage  # the microbatch this stage holds at tick t
            if not 0 <= mb < n_micro:
                ys.append(bufs[k])  # a fill or drain tick: nothing to compute
                continue
            with on(dev):
                y = stage_fn(block, micro[mb].to(dev) if stage == 0 else bufs[k])
            if stage == n_stages - 1:
                stored[k].append(y)
            ys.append(y)
        bufs = comm.ppermute(ys)
    # every stage but the last adds zeros: the outputs reach every stage
    parts = [torch.stack(s) if s else torch.zeros_like(micro, device=d)
             for s, d in zip(stored, comm.devices)]
    return comm.psum(parts)[0].reshape(xb.shape)


def pipeline_transformer_layers(layer_params: list, x: torch.Tensor,
                                layer_fn: Callable, mesh: Mesh, axis: str = "model",
                                n_micro: int | None = None) -> torch.Tensor:
    """Pipeline L transformer layers over S stages (L % S == 0): stage s
    runs layers s L/S .. (s + 1) L/S - 1 in order.

    layer_params: L per-layer modules or tensor trees (e.g. Whisper's
    encoder blocks); layer_fn(one_layer, x) -> x. A stage's layers are
    copied to its device where they are not already there."""
    n_stages = mesh.shape[axis]
    n_layers = len(layer_params)
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    blocks = mesh.place(lambda s, dev: [_place(p, dev) for p in
                                        layer_params[s * per:(s + 1) * per]], axis)

    def stage_fn(block: list, xb: torch.Tensor) -> torch.Tensor:
        for layer in block:
            xb = layer_fn(layer, xb)
        return xb

    return _pipeline(blocks, x, stage_fn, mesh, n_micro, axis)
