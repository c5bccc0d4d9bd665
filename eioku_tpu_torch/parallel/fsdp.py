"""FSDP (ZeRO-3-style fully sharded data parallelism) over the data axis
(port of eioku_tpu/parallel/fsdp.py).

Every parameter and both AdamW moments live cut over the mesh's "data"
axis along their largest divisible dimension (`fsdp_spec`, the JAX rule on
the port's own [out, in] layout), as `ShardedTensor`s (parallel/mesh.py).
The JAX package declares the layout and lets XLA insert the collectives;
the port does it by hand: a step gathers each parameter over the data line
when the forward first reads it (an all_gather whose backward is the
reduce-scatter of the gradient, parallel/collectives.py), so every data
entry ends the backward with the summed gradient of its own slice, and
steps that slice with AdamW. Between steps each entry holds 1/n of every
large leaf. The loss is the JAX package's in-batch InfoNCE over the global
batch (parallel/train.py `sharded_info_nce`).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from eioku_tpu_torch.models.embed.minilm import MiniLM, embed_tp
from eioku_tpu_torch.parallel.collectives import LocalCollectives
from eioku_tpu_torch.parallel.mesh import Mesh, ShardedTensor, tree_leaves, tree_map
from eioku_tpu_torch.parallel.train import (
    adamw,
    psum_grads,
    sharded_info_nce,
    sum_copies,
    unique,
)

SMALL_LEAF = 1024  # max_leaf_shard_fraction ignores leaves this small


def fsdp_spec(shape: tuple[int, ...], n_shards: int) -> int | None:
    """The dimension to cut over `n_shards`: the largest one that divides
    (the first on ties); None for a scalar or an indivisible shape, which
    stay whole (their memory is negligible: the big leaves are the
    divisible matmul weights)."""
    divisible = [d for d in range(len(shape))
                 if shape[d] % n_shards == 0 and shape[d] >= n_shards]
    if not divisible:
        return None
    return max(divisible, key=lambda d: shape[d])


def _data_line(mesh: Mesh, axis: str):
    if axis != "data":
        raise ValueError("FSDP shards over the data axis")
    if mesh.shape["model"] != 1:
        raise ValueError("FSDP runs on a mesh whose model axis is 1")
    return mesh.lines("data")[0]


def shard_tree_fsdp(tree, mesh: Mesh, axis: str = "data"):
    """A module's state dict, or a dict / list tree of tensors or numpy
    arrays, laid out FSDP-sharded: each leaf a `ShardedTensor` over the
    data line, copied (a whole leaf once per device)."""
    line = _data_line(mesh, axis)
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    n = mesh.shape[axis]

    def leaf(x) -> ShardedTensor:
        t = x.detach() if torch.is_tensor(x) else torch.from_numpy(np.array(x))
        return ShardedTensor.cut(t, fsdp_spec(tuple(t.shape), n), line)
    return tree_map(leaf, tree)


class _Gathered(Mapping):
    """A parameter mapping for local entry k whose tensors are gathered
    over the data line on first read, once per step for every entry."""

    def __init__(self, params: dict[str, ShardedTensor], cache: dict, k: int):
        self.params, self.cache, self.k = params, cache, k

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self.cache:
            self.cache[name] = self.params[name].on_entries()
        return self.cache[name][self.k]

    def __iter__(self):
        return iter(self.params)

    def __len__(self) -> int:
        return len(self.params)


def make_fsdp_train_step(model: MiniLM, mesh: Mesh, optimizer=None, axis: str = "data"):
    """FSDP variant of parallel/train.py's step: the same loss and
    optimizer, the parameters and both moments resident cut over `axis`.

    Returns (train_step, optimizer, prepare), as the JAX function does:
    prepare(model_or_state) lays out the parameters (trainable) and a fresh
    optimizer state, {"exp_avg": .., "exp_avg_sq": .. (trees of
    ShardedTensors in the parameters' layout), "step": a scalar};
    train_step(params, opt_state, anchor_ids, anchor_mask, pos_ids,
    pos_mask) takes one step on the global batch, updates both in place
    (the layout holds) and returns (params, opt_state, loss before the
    step). optimizer: a function from a list of tensors to a torch Adam or
    AdamW (default `adamw`); each step binds one to the slices and their
    moments."""
    cfg = model.cfg
    line = _data_line(mesh, axis)
    optimizer = optimizer or adamw

    def prepare(model_or_state):
        params = shard_tree_fsdp(model_or_state, mesh, axis)
        for leaf in tree_leaves(params):
            for p in leaf.unique_parts():
                p.requires_grad_(True)

        def zeros(leaf: ShardedTensor) -> ShardedTensor:
            return leaf.map(lambda p: torch.zeros_like(p, requires_grad=False))
        return params, {"exp_avg": tree_map(zeros, params),
                        "exp_avg_sq": tree_map(zeros, params),
                        "step": torch.zeros(())}

    def train_step(params, opt_state, anchor_ids, anchor_mask, pos_ids, pos_mask):
        leaves = tree_leaves(params)
        slices = unique(p for leaf in leaves for p in leaf.parts)
        for p in slices:
            p.grad = None
        cache: dict = {}

        def embed_entry(k, ids, mask):
            return embed_tp([_Gathered(params, cache, k)],
                            LocalCollectives([line.devices[k]]), ids, mask, cfg)[0]
        mine, loss = sharded_info_nce(embed_entry, line, anchor_ids, anchor_mask,
                                      pos_ids, pos_mask)
        mine.backward()
        # the cut slices hold their reduce-scattered gradients; a whole
        # leaf's gradient is summed over the line
        whole = [leaf for leaf in leaves if leaf.dim is None]
        if "data" in mesh.groups:
            psum_grads(line, [p for leaf in whole for p in leaf.unique_parts()])
        else:
            sum_copies(leaf.unique_parts() for leaf in whole)
        opt = optimizer(slices)
        moments = [tree_leaves(opt_state[k]) for k in ("exp_avg", "exp_avg_sq")]
        for leaf, m, v in zip(leaves, *moments):
            for p, mp, vp in zip(leaf.parts, m.parts, v.parts):
                opt.state[p] = {"step": opt_state["step"].clone(), "exp_avg": mp,
                                "exp_avg_sq": vp}
        opt.step()
        opt_state["step"] += 1
        return params, opt_state, loss

    return train_step, optimizer, prepare


def gather_tree(tree):
    """The whole tensors of a tree of ShardedTensors (a collective over
    processes), detached, on each leaf's first local device."""
    with torch.no_grad():
        return tree_map(lambda x: x.full().detach() if isinstance(x, ShardedTensor)
                        else x, tree)


def gradients(params):
    """The whole gradients of the last step's slices (summed over the data
    line), gathered as `gather_tree` gathers the parameters."""
    return gather_tree(tree_map(lambda leaf: leaf.map(lambda p: p.grad), params))


def max_leaf_shard_fraction(tree) -> float:
    """Diagnostic: the largest share of a leaf that one entry holds (1.0 =
    whole, 1/n = fully cut), over leaves of at least SMALL_LEAF elements.
    Used by the tests and chip_smoke.py to show that memory shards."""
    worst = 0.0
    for leaf in tree_leaves(tree):
        size = leaf.numel() if torch.is_tensor(leaf) else \
            int(torch.Size(leaf.shape).numel())
        if size < SMALL_LEAF:
            continue
        held = leaf.numel() if torch.is_tensor(leaf) else leaf.parts[0].numel()
        worst = max(worst, held / size)
    return worst
