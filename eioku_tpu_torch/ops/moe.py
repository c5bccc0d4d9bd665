"""Mixture-of-experts layer with expert parallelism (port of
eioku_tpu/ops/moe.py).

E expert FFNs, tokens routed top-1 (Switch) with a fixed per-expert
capacity C = ceil(n / E * factor); dispatch and combine are one-hot
products (the GShard formulation), as in the JAX package, where XLA places
the collectives from the sharding annotations. The port's expert
parallelism: `shard_moe_params` gives each device of the mesh's model axis
E/S whole experts (the router replicated); `moe_ffn` routes and dispatches
on the tokens' device, each device runs its experts on their slots, and
their outputs are gathered back for the combine. No Pallas kernel in the
JAX package, none here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from eioku_tpu_torch.parallel.collectives import on
from eioku_tpu_torch.parallel.mesh import Mesh, shard_slice


class MoeParams(NamedTuple):
    router: torch.Tensor   # [d, E]
    w1: torch.Tensor       # [E, d, ffn]
    b1: torch.Tensor       # [E, ffn]
    w2: torch.Tensor       # [E, ffn, d]
    b2: torch.Tensor       # [E, d]


def init_moe_params(d: int, ffn: int, n_experts: int, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cpu") -> MoeParams:
    """The JAX package's scheme (router N(0, 0.02), experts He-normal, zero
    biases) drawn from `generator`: other numbers than jax.random's, so
    tests carry the JAX arrays across with `from_jax_params`."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)
    return MoeParams(
        router=normal((d, n_experts), 0.02),
        w1=normal((n_experts, d, ffn), (2.0 / d) ** 0.5),
        b1=torch.zeros((n_experts, ffn), dtype=dtype, device=device),
        w2=normal((n_experts, ffn, d), (2.0 / ffn) ** 0.5),
        b2=torch.zeros((n_experts, d), dtype=dtype, device=device),
    )


def from_jax_params(params) -> MoeParams:
    """The JAX package's MoeParams (JAX or numpy arrays, same layouts) as
    CPU tensors."""
    return MoeParams(*(torch.from_numpy(np.array(a, np.float32)) for a in params))


def shard_moe_params(params: MoeParams, mesh: Mesh) -> list[MoeParams]:
    """Expert parallelism over the model axis of the mesh's first data row:
    entry j holds experts j E/S .. (j + 1) E/S - 1 (E % S == 0) and the
    router, on its device."""
    return mesh.place(lambda j, dev: MoeParams(
        params.router.to(dev),
        *(shard_slice(t, 0, j, mesh.shape["model"]).to(dev) for t in params[1:])))[0]


def _route(router: torch.Tensor, x: torch.Tensor, capacity: int):
    """Top-1 routing: (dispatch [n, E, C], combine [n, E, C]) in x's type."""
    n_experts = router.shape[1]
    gates = torch.softmax(x @ router, dim=-1)                    # [n, E]
    expert = gates.argmax(dim=-1)                                # [n]
    gate = gates.gather(1, expert[:, None])[:, 0]                # [n]
    onehot = F.one_hot(expert, n_experts).to(x.dtype)            # [n, E]
    # position of each token within its expert's queue (exclusive cumsum)
    pos = (torch.cumsum(onehot, dim=0) - onehot) * onehot        # [n, E]
    keep = (pos < capacity).to(x.dtype) * onehot                 # [n, E]
    # a position at or past the capacity has no slot (jax.nn.one_hot's zeros)
    slot = pos.sum(dim=1).long()
    pos_oh = F.one_hot(slot.clamp_max(capacity), capacity + 1)[:, :capacity].to(x.dtype)
    dispatch = keep[:, :, None] * pos_oh[:, None, :]
    return dispatch, dispatch * gate[:, None, None]


def _experts(p: MoeParams, xs: torch.Tensor) -> torch.Tensor:
    """The FFN of each expert in p on its slots xs [E', C, d]."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", xs, p.w1) + p.b1[:, None, :],
               approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, p.w2) + p.b2[:, None, :]


@torch.no_grad()
def moe_ffn(params: MoeParams | list[MoeParams], x: torch.Tensor,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-1 (Switch) MoE FFN over tokens x [n, d] -> [n, d].

    params: one MoeParams, or the expert shards of `shard_moe_params`.
    Tokens beyond an expert's capacity C = ceil(n/E * factor) are dropped:
    their output is 0 (callers use the layer inside a residual connection,
    so a dropped token passes through unchanged)."""
    shards = params if isinstance(params, list) else [params]
    n = x.shape[0]
    n_experts = shards[0].router.shape[1]
    capacity = int((n / n_experts) * capacity_factor + 0.999) or 1
    dispatch, combine = _route(shards[0].router.to(x.device), x, capacity)
    xs = torch.einsum("nec,nd->ecd", dispatch, x)                # [E, C, d]
    ys, start = [], 0
    for p in shards:
        dev, e = p.w1.device, p.w1.shape[0]
        with on(dev):
            ys.append(_experts(p, xs[start:start + e].to(dev)).to(x.device))
        start += e
    return torch.einsum("nec,ecd->nd", combine, torch.cat(ys))


@torch.no_grad()
def moe_ffn_reference(params: MoeParams, x: torch.Tensor) -> torch.Tensor:
    """Per-token reference without a capacity limit, for parity tests."""
    gates = torch.softmax(x @ params.router, dim=-1)
    expert = gates.argmax(dim=-1)
    gate = gates.gather(1, expert[:, None])[:, 0]
    h = F.gelu(torch.einsum("nd,ndf->nf", x, params.w1[expert]) + params.b1[expert],
               approximate="tanh")
    y = torch.einsum("nf,nfd->nd", h, params.w2[expert]) + params.b2[expert]
    return y * gate[:, None]

