"""Ring attention: context-parallel attention (port of
eioku_tpu/ops/ring_attention.py).

For sequences too long for one device (e.g. hour-scale audio encoded as one
context instead of 30 s windows), each device of a mesh axis holds one block
of the queries and one block of the keys and values; the K/V blocks rotate
around the ring (`ppermute`, parallel/collectives.py) while each device
attends its queries to the block in front of it, carrying the online-softmax
statistics (running max m, running sum l, unnormalised output o) across
blocks. After the ring has gone round, every query has seen every key.

The JAX package computes each block with plain einsums in fp32 (no Pallas
kernel), and so does the port. It rotates the blocks n - 1 times where the
JAX scan rotates n times (its last rotation's blocks are never read). The
shards' outputs are gathered along the sequence.
"""
from __future__ import annotations

import torch

from eioku_tpu_torch.parallel.collectives import on
from eioku_tpu_torch.parallel.mesh import Mesh, shard_slice

MASK_VALUE = -0.7 * 3.4e38


def _local_attention_stats(q, k, v, scale: float):
    """Partial attention of q against one KV block. q [B, H, Sq, D], k/v
    [B, H, Skv, D] -> (o_unnorm [B, H, Sq, D], m [B, H, Sq, 1], l [B, H,
    Sq, 1]), all fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o, m, l


def _ring(qs: list, ks: list, vs: list, comm, scale: float) -> list[torch.Tensor]:
    """The ring over one line of the mesh: each local shard's query block
    against every K/V block as they rotate past."""
    state = []
    for q, dev in zip(qs, comm.devices):
        b, h, sq, d = q.shape
        state.append((torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev),
                      torch.full((b, h, sq, 1), -torch.inf, dtype=torch.float32, device=dev),
                      torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)))
    for step in range(comm.size):
        if step:  # rotate the K/V blocks one device along the ring
            ks, vs = comm.ppermute(ks), comm.ppermute(vs)
        new = []
        for (o, m, l), q, k, v, dev in zip(state, qs, ks, vs, comm.devices):
            with on(dev):
                o_new, m_new, l_new = _local_attention_stats(q, k, v, scale)
                m_next = torch.maximum(m, m_new)
                alpha = torch.exp(m - m_next)
                beta = torch.exp(m_new - m_next)
                new.append((o * alpha + o_new * beta, m_next, l * alpha + l_new * beta))
        state = new
    return [(o / l.clamp_min(1e-30)).to(q.dtype) for (o, _, l), q in zip(state, qs)]


@torch.no_grad()
def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis_name: str = "data", scale: float | None = None) -> torch.Tensor:
    """Full attention with the sequence sharded over `axis_name`.

    q, k, v: [B, H, S, D] (S divisible by the axis size). Each device takes
    its block of the queries and of the keys and values; the ring runs on
    the mesh's first line along the axis (its other lines would compute the
    same). Returns [B, H, S, D] in q's type on q's device."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    comm = mesh.lines(axis_name)[0]
    n = comm.size
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"sequence lengths {q.shape[2]}, {k.shape[2]} must divide "
                         f"by the {axis_name} axis size {n}")
    qs, ks, vs = ([shard_slice(t, 2, i, n).to(dev) for i, dev in
                   zip(comm.indices, comm.devices)] for t in (q, k, v))
    out = _ring(qs, ks, vs, comm, scale)
    return comm.all_gather(out, dim=2)[0].to(q.device)
