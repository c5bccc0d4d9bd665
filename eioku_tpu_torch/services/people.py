"""Cross-video face identities ("People"): cluster ArcFace embeddings.

Copy of eioku_tpu/services/people.py for the PyTorch port.

The reference declared face clusters but shipped cluster_id = None
(ml-service/src/services/model_manager.py:390). Here the
face pipeline already assigns per-video track ids (ml/face_tracking.py) and,
with {"embeddings": true}, ArcFace identity vectors (ml/detection.py). This
service lifts tracks to library-wide identities:

1. Per (video, track): mean of the track's L2-normalized embeddings,
   re-normalized — one centroid per appearance of a person in a video.
2. Greedy agglomerative pass over track centroids (cosine distance,
   threshold default 0.45 — ArcFace's typical same-identity cutoff is
   ~0.3-0.5): each track joins the nearest person whose centroid is within
   threshold, else founds a new person. Person centroids update as running
   means, so later tracks see the refined identity.

Results are derived data (recomputable from envelopes, like projections) and
are memoized per artifact-set fingerprint rather than persisted.
"""
from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

log = logging.getLogger(__name__)

DEFAULT_THRESHOLD = 0.45


def _track_centroids(ctx) -> list[dict]:
    """One entry per (video, track) with a normalized mean embedding."""
    out = []
    for video in ctx.videos.list(limit=1_000_000):
        envs = ctx.artifacts.get_by_asset(
            video.id, artifact_type="face.detection",
            selection=ctx.policies.get_policy(video.id, "face.detection"))
        groups: dict[str, list] = defaultdict(list)
        spans: dict[str, list] = defaultdict(list)
        for e in envs:
            emb = e.payload_json.get("embedding")
            cid = e.payload_json.get("cluster_id")
            if not emb or cid is None:
                continue
            groups[cid].append(np.asarray(emb, np.float32))
            spans[cid].append(e.span_start_ms)
        for cid, vecs in groups.items():
            c = np.mean(vecs, axis=0)
            n = float(np.linalg.norm(c))
            if n < 1e-9:
                continue
            out.append({"video_id": video.id, "cluster_id": cid,
                        "centroid": c / n, "count": len(vecs),
                        "first_ms": min(spans[cid])})
    return out


def cluster_people(ctx, threshold: float = DEFAULT_THRESHOLD) -> list[dict]:
    """Group track centroids into persons. Returns persons sorted by total
    face count, each with its per-video occurrences."""
    tracks = _track_centroids(ctx)
    # biggest tracks first: persons are founded from the best-supported
    # centroids, so noisy one-frame tracks attach instead of seeding
    tracks.sort(key=lambda t: -t["count"])
    centroids: list[np.ndarray] = []
    weights: list[int] = []
    members: list[list[dict]] = []
    for t in tracks:
        if centroids:
            sims = np.stack(centroids) @ t["centroid"]
            best = int(np.argmax(sims))
            if 1.0 - float(sims[best]) <= threshold:
                w = weights[best]
                c = (centroids[best] * w + t["centroid"] * t["count"])
                c /= max(float(np.linalg.norm(c)), 1e-9)
                centroids[best] = c
                weights[best] = w + t["count"]
                members[best].append(t)
                continue
        centroids.append(t["centroid"].copy())
        weights.append(t["count"])
        members.append([t])
    persons = []
    for i, ms in enumerate(members):
        occurrences = [{"video_id": m["video_id"],
                        "cluster_id": m["cluster_id"],
                        "count": m["count"], "first_ms": m["first_ms"]}
                       for m in sorted(ms, key=lambda m: -m["count"])]
        persons.append({
            "person_id": f"person_{i}",
            "total_faces": int(sum(m["count"] for m in ms)),
            "video_count": len({m["video_id"] for m in ms}),
            "occurrences": occurrences,
        })
    persons.sort(key=lambda p: -p["total_faces"])
    for i, p in enumerate(persons):  # stable ids after the sort
        p["person_id"] = f"person_{i}"
    return persons


class PeopleService:
    """Memoizing wrapper: re-clusters only when the face artifacts changed
    (fingerprint = count + max created_at of face.detection rows)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self._memo: tuple | None = None  # (fingerprint, threshold, persons)

    def _fingerprint(self):
        row = self.ctx.db.query_one(
            "SELECT COUNT(*) AS n, MAX(created_at) AS m FROM artifacts"
            " WHERE artifact_type='face.detection'")
        return (row["n"], row["m"])

    def people(self, threshold: float = DEFAULT_THRESHOLD) -> list[dict]:
        fp = self._fingerprint()
        if self._memo and self._memo[0] == fp and self._memo[1] == threshold:
            return self._memo[2]
        persons = cluster_people(self.ctx, threshold)
        self._memo = (fp, threshold, persons)
        return persons
