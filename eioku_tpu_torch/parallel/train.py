"""The contrastive training step of the sentence embedder (port of
eioku_tpu/parallel/train.py), on one device.

In-batch InfoNCE: anchors and positives embed through MiniLM (the
differentiable `embed`), logits = a p^T / temperature in fp32, and the loss
is the cross-entropy of each anchor against its own positive, averaged.
The JAX step is a pure function of (params, opt_state) sharded over its
(data, model) mesh; the port's updates the module's parameters in place
with torch.optim.AdamW, which computes what `optax.adamw` computes with
betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (optax's default; torch's
own default decay is 1e-2, so it is passed explicitly). Sharding the step
over several cards is multi-GPU work, not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from eioku_tpu_torch.models.embed.minilm import MiniLM, embed

WEIGHT_DECAY = 1e-4  # optax.adamw's default


def info_nce_loss(model: MiniLM, anchor_ids: torch.Tensor, anchor_mask: torch.Tensor,
                  pos_ids: torch.Tensor, pos_mask: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """In-batch contrastive loss: anchors match their aligned positives."""
    a = embed(model, anchor_ids, anchor_mask)
    p = embed(model, pos_ids, pos_mask)
    logits = (a.float() @ p.float().T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)


def adamw(model: MiniLM, lr: float = 1e-5) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def make_train_step(model: MiniLM, optimizer: torch.optim.Optimizer | None = None):
    """(train_step, optimizer): train_step(anchor_ids, anchor_mask, pos_ids,
    pos_mask) takes one AdamW step on `model` (its parameters made
    trainable) and returns the loss before the step, as a tensor."""
    model.requires_grad_(True)
    optimizer = optimizer or adamw(model)

    def train_step(anchor_ids, anchor_mask, pos_ids, pos_mask) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = info_nce_loss(model, anchor_ids, anchor_mask, pos_ids, pos_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step, optimizer
