"""Embedder domain adaptation: fine-tune MiniLM on the library's own
transcripts (port of eioku_tpu/parallel/finetune.py).

Training pairs are self-supervised crops: two different word windows of the
same transcript chunk form an (anchor, positive) pair; in-batch InfoNCE
(parallel/train.py) pushes windows of the same chunk together and different
chunks apart. As in the JAX package, the step runs over a (data, model)
mesh of every device (parallel/mesh.py): the cards of `local_devices`, or
the ranks of the process group that `initialize_distributed` started (one
card each: rank r takes visible card r mod their count, so ranks numbered
host by host share out each host's cards), with MiniLM tensor-parallel
over `model_parallel` of them and the batch rounded up to a multiple of the
data axis. The JAX package's fallbacks of `model_parallel` are mirrored (a
degree that does not divide the device count, or MiniLM's vocabulary,
heads and width, runs at 1). The shards are gathered into the whole model
and saved by rank 0 as the native checkpoint (the JAX package's tree
layout, models/checkpoint.py) that `load_minilm` of either package picks
up, so the semantic index serves the adapted weights on its next start.
"""
from __future__ import annotations

import functools
import logging
import os
import random

import torch
import torch.distributed as dist

from eioku_tpu_torch.models.checkpoint import save_params
from eioku_tpu_torch.models.embed.minilm import load_minilm, to_jax_params
from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer
from eioku_tpu_torch.parallel import mesh as mesh_mod
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

    devices = mesh_mod.local_devices(dev)
    n_dev = dist.get_world_size() if dist.is_initialized() else len(devices)
    mp = max(model_parallel, 1)
    if n_dev % mp != 0:
        mp = 1
    # every sharded weight dim must divide too (tok_emb rows 30522 = 2*3*5087,
    # head dims 12): mp beyond 2 would fail placement mid-run
    for dim in (cfg.vocab_size, cfg.n_heads, cfg.dim):
        if dim % mp != 0:
            log.warning("model_parallel=%d does not divide %d; running mp=1",
                        mp, dim)
            mp = 1
            break
    if dist.is_initialized():
        devices = [devices[dist.get_rank() % len(devices)]]
        mesh = mesh_mod.Mesh.over_world(devices[0], model_parallel=mp)
    else:
        mesh = mesh_mod.make_mesh(n_dev, model_parallel=mp, device=dev)
    n_data = mesh.shape["data"]
    # the batch shards over the data axis: round up to a multiple of it
    batch_size = -(-batch_size // n_data) * n_data
    step_fn, _ = make_train_step(model, functools.partial(adamw, lr=lr), mesh)

    rng = random.Random(seed)
    losses = []
    for step in range(steps):
        batch = [crop_pair(rng.choice(texts), rng) for _ in range(batch_size)]
        a_ids, a_mask = tokenizer.encode_batch([a for a, _ in batch])
        p_ids, p_mask = tokenizer.encode_batch([p for _, p in batch])
        put = lambda x: torch.from_numpy(x).to(devices[0])  # noqa: E731
        loss = step_fn(put(a_ids), put(a_mask), put(p_ids), put(p_mask))
        losses.append(float(loss))
        if step % 20 == 0:
            log.info("finetune step", extra={"step": step,
                                             "loss": round(losses[-1], 4)})
    out_path = save_to or (os.path.join(cache, "minilm-l6", "native.npz")
                           if cache else "minilm-native.npz")
    model.load_state_dict(step_fn.state_dict())  # a gather over the model axis
    if not dist.is_initialized() or dist.get_rank() == 0:
        save_params(to_jax_params(model), out_path)
    if dist.is_initialized():
        dist.barrier()
    return {"steps": steps, "first_loss": losses[0], "last_loss": losses[-1],
            "checkpoint": out_path, "chunks": len(texts),
            "mesh": dict(mesh.shape)}
