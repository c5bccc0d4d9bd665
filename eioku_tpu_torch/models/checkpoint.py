"""Native checkpoints (port of eioku_tpu/models/checkpoint.py).

`save_params` / `load_params`: a parameter tree in one npz, one array per
'/'-joined tree path, list indices as integers. Trees are nested dicts and
lists of numpy arrays or tensors, in the JAX package's layout
(models/embed/minilm.py `to_jax_params` builds MiniLM's), so the files one
package writes load in the other.

`save_sharded` / `restore_sharded`: a train state whose leaves are cut over
a mesh (`ShardedTensor`s of parallel/mesh.py: FSDP's parameters and AdamW
moments, parallel/fsdp.py) without gathering it through one process. The
JAX package uses orbax, which the card's host lacks, so the format is the
port's own: a directory with one `.npy` file per part of each leaf,
written by the process that holds the part, and `metadata.json` (each
leaf's tree path, global shape, dtype, cut dimension and part count). A
save writes into `<path>.tmp` and is published by a rename once every
part is on disk (after a barrier over processes; rank 0 renames), so a
save that dies leaves the previous checkpoint readable, as orbax's
finalize does. A restore reads, through memory maps, only the slices that
each entry of the template's layout needs, so a state saved on one mesh
resumes on another.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from eioku_tpu_torch.parallel.mesh import ShardedTensor


def _with_paths(tree, prefix: str = ""):
    """(tree path, leaf) pairs: dict keys in sorted order, list indices as
    integers."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map_with_paths(fn, tree, prefix: str = ""):
    """fn(tree path, leaf) over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_params(params, path: str) -> None:
    flat = {key: _numpy(leaf) for key, leaf in _with_paths(params)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params(template, path: str):
    """Load into the structure of `template` (shapes validated; each leaf
    takes the template leaf's dtype). Returns a tree of numpy arrays."""
    with np.load(path) as data:
        def fill(name: str, node):
            if name not in data:
                raise KeyError(f"checkpoint missing {name!r}")
            leaf = _numpy(node)
            arr = data[name]
            if arr.shape != leaf.shape:
                raise ValueError(f"shape mismatch at {name}: checkpoint "
                                 f"{arr.shape} vs model {leaf.shape}")
            return arr.astype(leaf.dtype)

        return _map_with_paths(fill, template)


# -- sharded (multi-device) checkpoints ------------------------------------------------

METADATA = "metadata.json"
_VIEW = {torch.bfloat16: torch.int16}  # types numpy lacks, stored as their bits


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _write_part(directory: str, name: str, t) -> None:
    """One part's file, written under a name of this process and renamed
    into place (processes that hold the same part write the same bytes)."""
    if torch.is_tensor(t):
        t = t.detach()
        t = t.view(_VIEW.get(t.dtype, t.dtype)).cpu().numpy()
    final = os.path.join(directory, name)
    partial = f"{final}.{_rank()}.partial"
    with open(partial, "wb") as f:
        np.save(f, np.asarray(t))
        f.flush()
        os.fsync(f.fileno())
    os.replace(partial, final)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_sharded(tree, path: str) -> None:
    """Save a tree whose leaves are ShardedTensors, tensors or numpy arrays
    (a tensor or an array counts as whole, held by every process). Every
    process that holds a part writes it; a whole leaf is written by rank 0.
    Every process of the default group calls this; it returns once the
    checkpoint is published."""
    path = os.path.abspath(path)
    tmp, rank = f"{path}.tmp", _rank()
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier()
    meta = []
    for i, (key, leaf) in enumerate(_with_paths(tree)):
        if isinstance(leaf, ShardedTensor):
            entry = {"shape": list(leaf.shape), "dtype": str(leaf.dtype).removeprefix("torch."),
                     "dim": leaf.dim, "n": leaf.n}
            written = set()
            for index, part in zip(leaf.line.indices, leaf.parts):
                index = 0 if leaf.dim is None else index
                if index in written or (leaf.dim is None and rank != 0):
                    continue
                written.add(index)
                _write_part(tmp, f"{i}.{index}.npy", part)
        else:
            arr = leaf if torch.is_tensor(leaf) else np.asarray(leaf)
            entry = {"shape": list(arr.shape),
                     "dtype": str(arr.dtype).removeprefix("torch."), "dim": None, "n": 1}
            if rank == 0:
                _write_part(tmp, f"{i}.0.npy", arr)
        meta.append({"path": key, "file": i, **entry})
    if rank == 0:
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"leaves": meta}, f)
            f.flush()
            os.fsync(f.fileno())
    _barrier()
    if rank == 0:
        _fsync_dir(tmp)
        old = f"{path}.old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        _fsync_dir(os.path.dirname(path))
        shutil.rmtree(old, ignore_errors=True)
    _barrier()


def _read_region(directory: str, meta: dict, dim: int | None, index: int,
                 n: int) -> np.ndarray:
    """Part `index` of `n` along `dim` (None: all) of a saved leaf, read
    from the saved parts that overlap it."""
    shape = meta["shape"]
    region = [slice(0, s) for s in shape]
    if dim is not None:
        k = shape[dim] // n
        region[dim] = slice(index * k, (index + 1) * k)

    def load(part: int):
        return np.load(os.path.join(directory, f"{meta['file']}.{part}.npy"), mmap_mode="r")
    saved = meta["dim"]
    if saved is None:
        return np.array(load(0)[tuple(region)])
    k = shape[saved] // meta["n"]
    lo, hi = region[saved].start, region[saved].stop
    pieces = []
    for part in range(lo // k, -(-hi // k)):
        r = list(region)
        r[saved] = slice(max(lo, part * k) - part * k, min(hi, (part + 1) * k) - part * k)
        pieces.append(load(part)[tuple(r)])
    return np.concatenate(pieces, axis=saved)


def _as_tensor(arr: np.ndarray, saved: str, dtype: torch.dtype, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if getattr(torch, saved) in _VIEW:
        t = t.view(getattr(torch, saved))
    return t.to(device=device, dtype=dtype)


def restore_sharded(template, path: str):
    """Restore into `template`'s structure, shapes, types and layout,
    whatever layout was saved: a ShardedTensor leaf comes back cut as the
    template's is (each local part read on its own, its device and
    `requires_grad` the template part's), a tensor whole on its device,
    an array as an array."""
    path = os.path.abspath(path)
    with open(os.path.join(path, METADATA)) as f:
        saved = {m["path"]: m for m in json.load(f)["leaves"]}

    def fill(key: str, leaf):
        if key not in saved:
            raise KeyError(f"checkpoint missing {key!r}")
        meta = saved[key]
        if tuple(meta["shape"]) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(meta['shape'])} vs template {tuple(leaf.shape)}")
        if isinstance(leaf, ShardedTensor):
            made: dict = {}
            parts = []
            for index, part in zip(leaf.line.indices, leaf.parts):
                at = (None if leaf.dim is None else index, part.device)
                if at not in made:
                    arr = _read_region(path, meta, leaf.dim, index, leaf.n)
                    made[at] = _as_tensor(arr, meta["dtype"], part.dtype, part.device).requires_grad_(
                        part.requires_grad)
                parts.append(made[at])
            return ShardedTensor(leaf.shape, leaf.dim, leaf.line, parts)
        arr = _read_region(path, meta, None, 0, 1)
        if torch.is_tensor(leaf):
            return _as_tensor(arr, meta["dtype"], leaf.dtype, leaf.device)
        return arr.astype(np.asarray(leaf).dtype)
    return _map_with_paths(fill, template)
