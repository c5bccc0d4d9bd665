"""Native checkpoints: a parameter tree in one npz, one array per
'/'-joined tree path, list indices as integers (port of
eioku_tpu/models/checkpoint.py `save_params` / `load_params`).

Trees are nested dicts and lists of numpy arrays or tensors, in the JAX
package's layout (models/embed/minilm.py `to_jax_params` builds MiniLM's),
so the files one package writes load in the other. The sharded
(multi-device) checkpoints of the JAX package, `save_sharded` and
`restore_sharded`, are not ported: they belong to multi-GPU training.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = tree.detach().cpu().numpy() if torch.is_tensor(tree) \
            else np.asarray(tree)


def save_params(params, path: str) -> None:
    flat: dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params(template, path: str):
    """Load into the structure of `template` (shapes validated; each leaf
    takes the template leaf's dtype). Returns a tree of numpy arrays."""
    with np.load(path) as data:
        def fill(node, key: str):
            if isinstance(node, dict):
                return {k: fill(v, f"{key}{k}/") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(fill(v, f"{key}{i}/") for i, v in enumerate(node))
            name = key[:-1]
            if name not in data:
                raise KeyError(f"checkpoint missing {name!r}")
            leaf = node.detach().cpu().numpy() if torch.is_tensor(node) else np.asarray(node)
            arr = data[name]
            if arr.shape != leaf.shape:
                raise ValueError(f"shape mismatch at {name}: checkpoint "
                                 f"{arr.shape} vs model {leaf.shape}")
            return arr.astype(leaf.dtype)

        return fill(template, "")
