"""Embedder domain adaptation: fine-tune MiniLM on the library's own
transcripts (port of eioku_tpu/parallel/finetune.py), on one card.

Training pairs are self-supervised crops: two different word windows of the
same transcript chunk form an (anchor, positive) pair; in-batch InfoNCE
(parallel/train.py) pushes windows of the same chunk together and different
chunks apart. The result is saved as the native checkpoint (the JAX
package's tree layout, models/checkpoint.py) that `load_minilm` of either
package picks up, so the semantic index serves the adapted weights on its
next start.

The JAX package shards the step over its (data, model) mesh, which spans
every visible device, and rounds the batch up to a multiple of the data
axis. The port trains on one card on every host, and rounds the batch as
the JAX package would on that host: up to a multiple of the visible cards
(the data axis at `model_parallel` 1), so that both draw the same pairs;
on the CPU, one device, the batch is not rounded. Its fallbacks of
`model_parallel` are mirrored (a degree that does not divide the device
count, or MiniLM's vocabulary, heads and width, runs at 1); where it would
shard the model over several devices, the port raises ModelNotAvailable:
multi-GPU training is not ported.
"""
from __future__ import annotations

import logging
import os
import random

import torch

from eioku_tpu_torch.ml.engine import ModelNotAvailable
from eioku_tpu_torch.models.checkpoint import save_params
from eioku_tpu_torch.models.embed.minilm import load_minilm, to_jax_params
from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer
from eioku_tpu_torch.parallel.train import adamw, make_train_step
from eioku_tpu_torch.utils.device import entry_point_device, resolve_device

log = logging.getLogger(__name__)


def crop_pair(text: str, rng: random.Random, min_frac: float = 0.5
              ) -> tuple[str, str]:
    words = text.split()
    if len(words) < 4:
        return text, text
    n = len(words)

    def crop():
        size = max(int(n * (min_frac + rng.random() * (1 - min_frac))), 2)
        start = rng.randint(0, n - size)
        return " ".join(words[start:start + size])

    return crop(), crop()


def visible_devices(dev: torch.device) -> int:
    """The devices the JAX package's mesh would span on this host: every
    visible card for a CUDA device, else 1."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def finetune_embedder(ctx, steps: int = 100, batch_size: int = 16,
                      lr: float = 1e-5, seed: int = 0,
                      model_parallel: int = 1,
                      save_to: str | None = None,
                      device: str | torch.device | None = None) -> dict:
    """Fine-tune on all indexed transcript chunks; returns training stats.
    device: None takes the entry points' rule (EIOKU_FORCE_CPU=1 means the
    CPU, otherwise CUDA)."""
    dev = resolve_device(device if device is not None
                         else entry_point_device(needs_card=False))
    rows = ctx.db.query("SELECT text FROM embedding_chunks")
    texts = [r["text"] for r in rows if len(r["text"].split()) >= 4]
    if len(texts) < batch_size:
        raise ValueError(
            f"need at least {batch_size} (mesh-rounded) indexed chunks to fine-tune, "
            f"have {len(texts)}")
    cache = ctx.config.model_cache_dir
    model, cfg, _ = load_minilm(cache, device=dev)
    tokenizer = WordPieceTokenizer.from_cache_dir(cache, max_len=128)

    n_dev = visible_devices(dev)
    mp = max(model_parallel, 1)
    if n_dev % mp != 0:
        mp = 1
    for dim in (cfg.vocab_size, cfg.n_heads, cfg.dim):
        if dim % mp != 0:
            log.warning("model_parallel=%d does not divide %d; running mp=1",
                        mp, dim)
            mp = 1
            break
    if mp > 1:
        raise ModelNotAvailable(
            f"model_parallel={mp} (MiniLM sharded over {mp} cards) is not ported "
            "to eioku_tpu_torch: fine-tuning runs on one card")
    # the JAX package's data axis is every device at mp 1: the same rounded
    # batch, trained here on one card
    rounded = -(-batch_size // n_dev) * n_dev
    if rounded != batch_size:
        log.info("finetune batch rounded up as the JAX package's mesh rounds it",
                 extra={"batch_size": batch_size, "rounded": rounded,
                        "devices": n_dev})
        batch_size = rounded
    step_fn, _ = make_train_step(model, adamw(model, lr))

    rng = random.Random(seed)
    losses = []
    for step in range(steps):
        batch = [crop_pair(rng.choice(texts), rng) for _ in range(batch_size)]
        a_ids, a_mask = tokenizer.encode_batch([a for a, _ in batch])
        p_ids, p_mask = tokenizer.encode_batch([p for _, p in batch])
        put = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        loss = step_fn(put(a_ids), put(a_mask), put(p_ids), put(p_mask))
        losses.append(float(loss))
        if step % 20 == 0:
            log.info("finetune step", extra={"step": step,
                                             "loss": round(losses[-1], 4)})
    out_path = save_to or (os.path.join(cache, "minilm-l6", "native.npz")
                           if cache else "minilm-native.npz")
    save_params(to_jax_params(model), out_path)
    return {"steps": steps, "first_loss": losses[0], "last_loss": losses[-1],
            "checkpoint": out_path, "chunks": len(texts),
            "mesh": {"data": 1, "model": mp}}
