"""The contrastive training step of the sentence embedder (port of
eioku_tpu/parallel/train.py), on one device or over a (data, model) mesh.

In-batch InfoNCE: anchors and positives embed through MiniLM (the
differentiable `embed`), logits = a p^T / temperature in fp32, and the loss
is the cross-entropy of each anchor against its own positive, averaged
over the batch. The port's step updates its parameters in place with
torch.optim.AdamW, which computes what `optax.adamw` computes with betas
(0.9, 0.999), eps 1e-8 and weight decay 1e-4 (optax's default; torch's own
default decay is 1e-2, so it is passed explicitly).

Over a mesh (parallel/mesh.py), as the JAX step runs on its sharded
params: the batch splits over "data", and each data line embeds its rows
through MiniLM's tensor-parallel forward (`embed_tp`) over its model line.
The loss stays the JAX package's, in-batch over the GLOBAL batch: the
positives' embeddings are gathered over "data" (an all_gather whose
backward returns each line its slice of the summed gradient), each line
sums its anchors' cross-entropy against all of them and divides by the
global batch size, and the gradients are then summed over "data". Each
model shard steps its own parameter slices, distinct tensors, with AdamW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eioku_tpu_torch.models.embed.minilm import MiniLM, embed, embed_tp
from eioku_tpu_torch.parallel.collectives import on
from eioku_tpu_torch.parallel.mesh import Mesh, _minilm_dim, shard_slice

WEIGHT_DECAY = 1e-4  # optax.adamw's default
TEMPERATURE = 0.05


def info_nce_loss(model: MiniLM, anchor_ids: torch.Tensor, anchor_mask: torch.Tensor,
                  pos_ids: torch.Tensor, pos_mask: torch.Tensor,
                  temperature: float = TEMPERATURE) -> torch.Tensor:
    """In-batch contrastive loss: anchors match their aligned positives."""
    a = embed(model, anchor_ids, anchor_mask)
    p = embed(model, pos_ids, pos_mask)
    logits = (a.float() @ p.float().T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)


def sharded_info_nce(embed_entry, data_line, anchor_ids: torch.Tensor,
                     anchor_mask: torch.Tensor, pos_ids: torch.Tensor,
                     pos_mask: torch.Tensor, temperature: float = TEMPERATURE
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`info_nce_loss` over the global batch [B, S], split over a data line.

    The line's k-th local entry, part r = data_line.indices[k] of its
    size, embeds rows [r b, (r + 1) b) of each side (embed_entry(k, ids,
    mask) -> [b, dim]); the positives are gathered over the line, and each
    anchor's cross-entropy runs against all B of them. Returns (the sum of
    the local entries' cross-entropy over B, which this process
    backpropagates; the loss, that sum over the whole line, detached)."""
    total = anchor_ids.shape[0]
    if total % data_line.size:
        raise ValueError(f"batch {total} must divide by the data axis ({data_line.size})")
    b = total // data_line.size
    local = range(len(data_line.devices))

    def rows(t: torch.Tensor, k: int) -> torch.Tensor:
        return t[data_line.indices[k] * b:(data_line.indices[k] + 1) * b]
    anchors = [embed_entry(k, rows(anchor_ids, k), rows(anchor_mask, k)) for k in local]
    positives = data_line.all_gather(
        [embed_entry(k, rows(pos_ids, k), rows(pos_mask, k)) for k in local], dim=0)
    losses = []
    for k, dev in zip(local, data_line.devices):
        with on(dev):
            logits = (anchors[k].float() @ positives[k].float().T) / temperature
            labels = torch.arange(b, device=logits.device) + data_line.indices[k] * b
            losses.append(F.cross_entropy(logits, labels, reduction="sum") / total)
    home = losses[0].device
    mine = losses[0]
    for x in losses[1:]:
        mine = mine + x.to(home)
    return mine, data_line.psum([x.detach() for x in losses])[0]


def adamw(params: nn.Module | list[torch.Tensor], lr: float = 1e-5) -> torch.optim.AdamW:
    """AdamW with optax.adamw's hyperparameters over a module's parameters
    or a list of tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def unique(tensors) -> list[torch.Tensor]:
    """The distinct tensors, in first-seen order."""
    return list({id(t): t for t in tensors}.values())


def sum_copies(copies) -> None:
    """Backend (a) of parallel/collectives.py: each list holds the distinct
    tensors that carry one value (the same parameter on several devices),
    each with the gradient of its own uses; give each the sum."""
    for ts in copies:
        ts = [t for t in unique(ts) if t.grad is not None]
        if len(ts) < 2:
            continue
        total = ts[0].grad
        for t in ts[1:]:
            total = total + t.grad.to(total.device)
        for t in ts:
            t.grad = total.to(t.device, copy=True)


def psum_grads(line, leaves: list[torch.Tensor]) -> None:
    """Backend (b): sum the leaves' gradients over the line's ranks, in one
    flat buffer (a leaf no rank used has a zero gradient)."""
    if not leaves:
        return
    flat = torch.cat([(t.grad if t.grad is not None else torch.zeros_like(t)).reshape(-1)
                      for t in leaves])
    (flat,) = line.psum([flat])
    for t, g in zip(leaves, flat.split([t.numel() for t in leaves])):
        t.grad = g.view_as(t)


class ShardedTrainStep:
    """One AdamW step of the contrastive loss over a (data, model) mesh.

    The model's parameters are cut once into each entry's Megatron shard
    (`_minilm_dim`) and copied into trainable tensors: a cut tensor once
    per (model index, device), a whole one once per device, so entries on
    one device share them and autograd sums their uses. `optimizer` builds
    the optimizer over those tensors (default `adamw`)."""

    def __init__(self, model: MiniLM, mesh: Mesh, optimizer=None):
        self.cfg, self.mesh = model.cfg, mesh
        tp = mesh.shape["model"]
        state = model.state_dict()
        made: dict = {}

        def shard(index: int, dev: torch.device) -> dict[str, torch.Tensor]:
            out = {}
            for name, t in state.items():
                dim = _minilm_dim(name)
                key = (name, None if dim is None else index, dev)
                if key not in made:
                    made[key] = shard_slice(t, dim, index, tp).to(
                        dev, copy=True, memory_format=torch.contiguous_format
                    ).requires_grad_(True)
                out[name] = made[key]
            return out
        self.entries = mesh.line_entries(mesh.place(shard))  # per data line, its shards
        self.model_lines = mesh.lines("model")
        self.data_line = mesh.lines("data")[0]
        self.leaves = unique(made.values())
        copies: dict = {}
        for (name, index, _), t in made.items():
            copies.setdefault((name, index), []).append(t)
        self.copies = list(copies.values())
        self.optimizer = (optimizer or adamw)(self.leaves)

    def __call__(self, anchor_ids, anchor_mask, pos_ids, pos_mask) -> torch.Tensor:
        """One step on the global batch (every process passes all of it);
        returns the loss before the step."""
        self.optimizer.zero_grad(set_to_none=True)

        def embed_entry(k, ids, mask):
            return embed_tp(self.entries[k], self.model_lines[k], ids, mask, self.cfg)[0]
        mine, loss = sharded_info_nce(embed_entry, self.data_line, anchor_ids, anchor_mask,
                                      pos_ids, pos_mask)
        mine.backward()
        if "data" in self.mesh.groups:
            psum_grads(self.data_line, self.leaves)
        else:
            sum_copies(self.copies)
        self.optimizer.step()
        return loss

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole parameters, gathered over the model line (a collective
        over processes), on the first local device, detached."""
        return self._gather(lambda t: t)

    def gradients(self) -> dict[str, torch.Tensor]:
        """The last step's whole gradients (summed over "data"), gathered
        as `state_dict` gathers the parameters."""
        return self._gather(lambda t: t.grad)

    def _gather(self, of) -> dict[str, torch.Tensor]:
        line, shards = self.model_lines[0], self.entries[0]
        out = {}
        with torch.no_grad():
            for name in shards[0]:
                dim = _minilm_dim(name)
                out[name] = (of(shards[0][name]) if dim is None
                             else line.all_gather([of(s[name]) for s in shards], dim=dim)[0])
        return {k: v.detach() for k, v in out.items()}


def make_train_step(model: MiniLM, optimizer=None, mesh: Mesh | None = None):
    """(train_step, optimizer): train_step(anchor_ids, anchor_mask, pos_ids,
    pos_mask) takes one AdamW step and returns the loss before the step, as
    a tensor.

    mesh None: the step on `model`'s device, which updates `model` (its
    parameters made trainable); `optimizer` is one over its parameters
    (default `adamw(model)`).
    mesh: the `ShardedTrainStep` over it, which trains the shards and
    leaves `model` as it is (`train_step.state_dict()` gathers them);
    `optimizer` is a function from a list of tensors to an optimizer
    (default `adamw`), like the JAX package's optax transformation."""
    if mesh is not None:
        step = ShardedTrainStep(model, mesh, optimizer)
        return step, step.optimizer
    model.requires_grad_(True)
    optimizer = optimizer or adamw(model)

    def train_step(anchor_ids, anchor_mask, pos_ids, pos_mask) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = info_nce_loss(model, anchor_ids, anchor_mask, pos_ids, pos_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step, optimizer
