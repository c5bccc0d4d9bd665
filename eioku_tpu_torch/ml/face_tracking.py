"""Face clustering via cross-frame IoU tracking (a copy of
eioku_tpu/ml/face_tracking.py; host only).

The upstream ML service declares face clusters (face_clusters projection,
cluster_id in the payload schema) but never implemented clustering:
cluster_id is always None there. This module implements the capability:
detections are linked across sampled frames by greedy IoU matching into
tracks, and each track becomes a cluster id ("face_0", "face_1", ...).
Identity-level clustering across shots can later replace the track ids with
embedding-based clusters (FaceDetectionV1 already carries an optional
embedding field).
"""
from __future__ import annotations

from dataclasses import dataclass, field


def _iou(a: dict, b: dict) -> float:
    ax1, ay1 = a["x"], a["y"]
    ax2, ay2 = a["x"] + a["width"], a["y"] + a["height"]
    bx1, by1 = b["x"], b["y"]
    bx2, by2 = b["x"] + b["width"], b["y"] + b["height"]
    ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    iy = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = ix * iy
    union = a["width"] * a["height"] + b["width"] * b["height"] - inter
    return inter / union if union > 0 else 0.0


@dataclass
class _Track:
    track_id: int
    box: dict
    last_frame: int


@dataclass
class FaceTracker:
    """Greedy IoU tracker over sampled frames (host-side, O(tracks x dets))."""

    iou_threshold: float = 0.3
    max_gap_frames: int = 3  # sampled frames a track may skip before closing
    frame_step: int = 1  # source frames between samples (gap is measured in
    #                      source-frame distance: face-free stretches must
    #                      expire tracks even though they produce no assigns)
    _tracks: list[_Track] = field(default_factory=list)
    _next_id: int = 0
    _frame_counter: int = 0

    def assign(self, detections: list[dict],
               frame_index: int | None = None) -> list[str]:
        """detections: bounding_box dicts for one sampled frame (time order).
        frame_index: the source frame number — tracks expire by source-frame
        distance, so identities separated by minutes of face-free video never
        merge. Falls back to call counting when omitted."""
        self._frame_counter += 1
        now = frame_index if frame_index is not None else self._frame_counter
        horizon = self.max_gap_frames * \
            (self.frame_step if frame_index is not None else 1)
        self._tracks = [t for t in self._tracks
                        if now - t.last_frame <= horizon]
        ids: list[str] = []
        used: set[int] = set()
        for det in detections:
            best, best_iou = None, self.iou_threshold
            for t in self._tracks:
                if t.track_id in used:
                    continue
                iou = _iou(t.box, det)
                if iou > best_iou:
                    best, best_iou = t, iou
            if best is not None:
                best.box = det
                best.last_frame = now
                used.add(best.track_id)
                ids.append(f"face_{best.track_id}")
            else:
                track = _Track(self._next_id, det, now)
                self._next_id += 1
                self._tracks.append(track)
                used.add(track.track_id)
                ids.append(f"face_{track.track_id}")
        return ids
