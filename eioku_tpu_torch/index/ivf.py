"""IVF (inverted-file) approximate retrieval with k-means on the device
(port of eioku_tpu/index/ivf.py).

- training: spherical Lloyd's k-means on the index's device, assignment a
  cosine matmul + argmax (first maximum), centroid update a segment sum;
  vectors are L2-normalised so cosine == dot;
- storage: vectors regrouped per cluster into a padded [k, m, D] block with
  a validity mask and a slot map, laid out on the host;
- search: score the centroids, take the top n_probe clusters, score only
  their blocks (padding at -inf), global top-k over the probed candidates.

Scores are fp32 matmuls of fp32 inputs, so they assume PyTorch's default
of no TF32 for fp32 matmuls on the card. Top-k ties go to the lower index
(`top_k`), as `lax.top_k` breaks them. The seeds of k-means come from a
`torch.Generator` (`_seed_indices`): the JAX package draws them with
`jax.random.choice`, so the two packages' centroids agree only when a test
gives both the same seeds.
"""
from __future__ import annotations

import numpy as np
import torch


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a 1-D fp32 `scores`, highest first, in `lax.top_k`'s
    order (`torch.topk` promises none): the IEEE total order, so -0.0 ranks
    below +0.0, and ties broken by the lower index. Every entry above the
    k-th key is in; of those equal to it, the lowest indices: a stable sort
    of that candidate set decides."""
    k = min(k, scores.shape[0])
    if k == 0:
        return scores[:0], torch.zeros(0, dtype=torch.long, device=scores.device)
    bits = scores.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # monotone in the total order
    kth = torch.topk(key, k).values[-1]
    cand = torch.nonzero(key >= kth).squeeze(1)  # ascending indices
    order = torch.sort(key[cand], descending=True, stable=True).indices[:k]
    idx = cand[order]
    return scores[idx], idx


def _seed_indices(n: int, k: int, seed: int, device: torch.device) -> torch.Tensor:
    """k distinct row indices in [0, n), drawn from a torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k].to(device)


def kmeans(vectors: torch.Tensor, k: int, iters: int = 10, seed: int = 0) -> torch.Tensor:
    """Spherical k-means on L2-normalised vectors [N, D] -> centroids [k, D]
    in the vectors' type."""
    n = vectors.shape[0]
    centroids = vectors[_seed_indices(n, k, seed, vectors.device)]
    vf = vectors.float()
    for _ in range(iters):
        assign = torch.argmax(vf @ centroids.float().T, dim=1)  # [N]
        sums = torch.zeros((k, vectors.shape[1]), dtype=torch.float32,
                           device=vectors.device).index_add_(0, assign, vf)
        counts = torch.bincount(assign, minlength=k).float()[:, None]
        new = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids.float())
        norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
        centroids = (new / norm.clamp_min(1e-9)).to(vectors.dtype)
    return centroids


def _ivf_search(centroids: torch.Tensor, blocks: torch.Tensor, mask: torch.Tensor,
                slot_map: torch.Tensor, query: torch.Tensor, n_probe: int,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """centroids [k, D]; blocks [k, m, D]; mask [k, m]; slot_map [k, m]
    (global slot per row, -1 padding); query [D]. Returns (scores, slots),
    top k."""
    c_scores = centroids.float() @ query
    _, probe = top_k(c_scores, n_probe)
    scores = blocks[probe].float() @ query  # [n_probe, m]
    scores = scores.masked_fill(~mask[probe], float("-inf")).reshape(-1)
    top_scores, top_idx = top_k(scores, k)
    return top_scores, slot_map[probe].reshape(-1)[top_idx]


class IvfIndex:
    def __init__(self, centroids, blocks, mask, slot_map, n_vectors: int):
        self.centroids = centroids
        self.blocks = blocks
        self.mask = mask
        self.slot_map = slot_map
        self.n_vectors = n_vectors
        self.k = centroids.shape[0]

    @classmethod
    def build(cls, vectors, k: int | None = None, iters: int = 10) -> "IvfIndex":
        """vectors [N, D] (numpy, or a tensor on the index's device;
        L2-normalised here in fp32). k-means and the assignment run on that
        device; the padded layout is made on the host, then the index lives
        on the device."""
        v = torch.as_tensor(vectors).to(torch.float32)
        n = v.shape[0]
        if k is None:
            k = max(int(np.sqrt(n)), 4)
        k = max(min(k, n), 1)  # k-means samples k seeds without replacement
        v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(1e-9)
        centroids = kmeans(v, k=k, iters=iters)
        assign = torch.argmax(v @ centroids.T, dim=1).cpu().numpy()
        counts = np.bincount(assign, minlength=k)
        m = max(int(counts.max()), 1)
        # per cluster, its slots in ascending order (the JAX loop's fill order)
        order = np.argsort(assign, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rows = np.arange(n) - starts[assign[order]]
        slot_map = np.full((k, m), -1, np.int64)
        slot_map[assign[order], rows] = order
        mask = slot_map >= 0
        dev_slots = torch.from_numpy(slot_map).to(v.device)
        blocks = torch.zeros((k, m, v.shape[1]), dtype=torch.float32, device=v.device)
        blocks[torch.from_numpy(mask).to(v.device)] = v[dev_slots[dev_slots >= 0]]
        return cls(centroids, blocks, torch.from_numpy(mask).to(v.device), dev_slots, n)

    def search(self, query: np.ndarray, top_k: int = 10,
               n_probe: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Returns (scores, global slots); padded entries have slot -1."""
        if n_probe is None:
            n_probe = max(self.k // 8, 1)
        n_probe = min(n_probe, self.k)
        q = np.asarray(query, np.float32)
        q = q / max(np.linalg.norm(q), 1e-9)
        scores, slots = _ivf_search(self.centroids, self.blocks, self.mask, self.slot_map,
                                    torch.from_numpy(q).to(self.blocks.device),
                                    n_probe, top_k)
        return scores.cpu().numpy(), slots.cpu().numpy()
