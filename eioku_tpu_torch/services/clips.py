"""Clip export: cut [start_ms, end_ms] of a library video into a shareable
file.

Copy of eioku_tpu/services/clips.py for the PyTorch port.

Beyond the reference (which can only stream whole files): a search or jump
hit becomes a portable clip. Primary path is the native stream-copy remux
(native/audio_decode.cpp:eioku_clip_remux — no re-encode, milliseconds per
clip, cut snapped to the keyframe at-or-before start like every copy-based
cutter). Fallback without the toolchain: cv2 re-encode of the frame range
(mp4v, video-only).

Serving: GET /videos/{id}/clip?start_ms=&end_ms= renders into a bounded
on-disk cache keyed by (file identity, span) so repeat downloads are free.
"""
from __future__ import annotations

import logging
import os
import tempfile

log = logging.getLogger(__name__)

MAX_CLIP_MS = 10 * 60 * 1000  # bound server work per request
_CACHE_DIR = os.path.join(tempfile.gettempdir(), "eioku_clips")
_CACHE_MAX = 64  # files; LRU by mtime


def export_clip(src: str, dst: str, start_ms: int, end_ms: int) -> bool:
    """Write the clip to dst. Returns False when both paths fail."""
    if end_ms <= start_ms:
        return False
    from eioku_tpu_torch.ml.audio_io import native_decoder
    lib = native_decoder()
    if lib is not None:
        rc = lib.eioku_clip_remux(src.encode(), dst.encode(),
                                  int(start_ms), int(end_ms))
        if rc == 0 and os.path.getsize(dst) > 0:
            return True
        log.warning("native clip remux failed rc=%s; re-encoding", rc)
    return _reencode_clip(src, dst, start_ms, end_ms)


def _reencode_clip(src: str, dst: str, start_ms: int, end_ms: int) -> bool:
    import cv2
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        return False
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.set(cv2.CAP_PROP_POS_MSEC, start_ms)
        out = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                              (w, h))
        if not out.isOpened():  # e.g. mp4v fourcc into a .webm container
            return False
        wrote = 0
        while cap.get(cv2.CAP_PROP_POS_MSEC) <= end_ms:
            ok, frame = cap.read()
            if not ok:
                break
            out.write(frame)
            wrote += 1
        out.release()
        return wrote > 0 and os.path.getsize(dst) > 0
    finally:
        cap.release()


def clip_path(video_path: str, file_hash: str, start_ms: int,
              end_ms: int) -> str | None:
    """Cached clip for (identity, span): returns the on-disk path, rendering
    it on a miss; None when export fails."""
    os.makedirs(_CACHE_DIR, exist_ok=True)
    ext = os.path.splitext(video_path)[1].lower() or ".mp4"
    if ext not in (".mp4", ".mov", ".m4v", ".mkv", ".webm"):
        ext = ".mp4"  # remux of esoteric containers lands in mp4
    # hash-less videos (POST /videos without file_hash) must not collide on
    # a shared constant — fall back to the path identity
    import xxhash
    ident = file_hash or xxhash.xxh64(video_path.encode()).hexdigest()
    name = f"{ident}_{start_ms}_{end_ms}{ext}"
    path = os.path.join(_CACHE_DIR, name)
    if os.path.isfile(path) and os.path.getsize(path) > 0:
        os.utime(path)  # LRU touch
        return path
    # mkstemp: concurrent renders of the SAME span run as threads in one
    # process (asyncio.to_thread), so a shared tmp name would let one
    # render truncate the other mid-write (same race the thumbnail cache
    # documents); the tmp_ prefix keeps eviction away from in-flight files
    fd, tmp = tempfile.mkstemp(prefix="tmp_", suffix=ext, dir=_CACHE_DIR)
    os.close(fd)
    ok = False
    try:
        ok = export_clip(video_path, tmp, start_ms, end_ms)
        if ok:
            os.replace(tmp, path)
    finally:
        if os.path.isfile(tmp):
            os.unlink(tmp)
    if not ok:
        return None
    _evict()
    return path


def _evict() -> None:
    try:
        entries = [(os.path.getmtime(os.path.join(_CACHE_DIR, f)),
                    os.path.join(_CACHE_DIR, f))
                   for f in os.listdir(_CACHE_DIR)
                   if not f.startswith("tmp_")]
        entries.sort()
        for _, p in entries[:-_CACHE_MAX]:
            os.unlink(p)
    except OSError:
        pass
