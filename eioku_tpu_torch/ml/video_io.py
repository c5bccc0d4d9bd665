"""Host-side video decode feeding fixed-shape batched frame tensors.

Copy of eioku_tpu/ml/video_io.py for the PyTorch port, which imports nothing
of the JAX package. Decode stays on the host: frames are sampled at a
configurable interval, resized on the host to the model's input geometry
(overlapped with device compute via double-buffered prefetch) and stacked
into fixed-shape uint8 batches; the final partial batch is padded and masked.

Two decode backends:
  - native/video_decode.cpp (preferred on the serial path): libavcodec with
    DCT-domain `lowres` decode when the model input is much smaller than the
    source, and fused scale+YUV->RGB for sampled frames only. ctypes calls
    release the GIL, so prefetch overlaps device compute.
  - cv2 (fallback + the striped multi-worker path on many-core hosts).
"""
from __future__ import annotations

import logging
import os
import queue as _queue
import threading
from dataclasses import dataclass
from typing import Iterator

import cv2
import numpy as np

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class VideoInfo:
    path: str
    width: int
    height: int
    fps: float
    frame_count: int

    @property
    def duration_ms(self) -> int:
        if self.fps <= 0:
            return 0
        return int(round(self.frame_count / self.fps * 1000.0))


@dataclass
class FrameBatch:
    """A fixed-shape batch of sampled frames.

    frames: uint8 [B, H, W, 3] RGB; entries past `valid` are zero padding.
    frame_indices / timestamps_ms: per-slot source frame index and time.
    """

    frames: np.ndarray
    frame_indices: np.ndarray  # int32 [B]
    timestamps_ms: np.ndarray  # int32 [B]
    valid: int

    @property
    def batch_size(self) -> int:
        return self.frames.shape[0]


def _configure_video_lib(lib) -> None:
    import ctypes
    lib.eioku_video_open.restype = ctypes.c_int
    lib.eioku_video_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.eioku_video_read.restype = ctypes.c_int
    lib.eioku_video_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int)]
    lib.eioku_video_seek.restype = ctypes.c_int
    lib.eioku_video_seek.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.eioku_video_close.restype = None
    lib.eioku_video_close.argtypes = [ctypes.c_void_p]


def native_video_lib():
    """native/video_decode.cpp, or None when it can't build/link."""
    from eioku_tpu_torch.utils.native_build import load_native_lib
    return load_native_lib(
        "video_decode", _configure_video_lib,
        link_libs=("avformat", "avcodec", "swscale", "avutil"))


def _native_enabled() -> bool:
    # env first: the kill switch must short-circuit the build/dlopen entirely
    return os.environ.get("EIOKU_NATIVE_DECODE", "1") != "0" and \
        native_video_lib() is not None


def _decode_flags(fast_level: int, step: int) -> int:
    """Map the analysis-decode speed level to native open() flags.

    0 = bit-exact (cv2 parity). 1 = skip the in-loop deblocking filter
    (~15-30% less decode CPU; LSB-level drift, invisible at model input
    scales). 2 = additionally skip non-reference frames when the sample
    step is sparse enough (>= 4) that samples snap at most a couple of
    frames — skipped frames' motion-comp cost vanishes entirely."""
    flags = 0
    if fast_level >= 1:
        flags |= 1
    if fast_level >= 2 and step >= 4:
        flags |= 2
    return flags


def _decode_native(path, fps, step, batch_size, resize_hw, max_frames,
                   start_frame: int = 0, end_frame: int = -1,
                   fast_level: int = 0) -> Iterator[FrameBatch]:
    """Sampled decode of [start_frame, end_frame) through the native shim.
    Mirrors _decode_segment's contract: same sampled frame set (indices are
    multiples of `step` counted from frame 0), same batch shapes. lowres only
    engages when resize_hw is much smaller than the source, so output
    geometry always equals the cv2 path's. ctypes releases the GIL during
    decode, so stripe workers and the prefetch thread truly overlap.
    fast_level engages the analysis-decode accelerators (_decode_flags)."""
    import ctypes
    lib = native_video_lib()
    target_h, target_w = resize_hw if resize_hw is not None else (0, 0)
    h = ctypes.c_void_p()
    src_w = ctypes.c_int()
    src_h = ctypes.c_int()
    out_w = ctypes.c_int()
    out_h = ctypes.c_int()
    c_fps = ctypes.c_double()
    nf = ctypes.c_longlong()
    ret = lib.eioku_video_open(path.encode(), target_w, target_h, 3,
                               _decode_flags(fast_level, step),
                               ctypes.byref(h), ctypes.byref(src_w),
                               ctypes.byref(src_h), ctypes.byref(out_w),
                               ctypes.byref(out_h), ctypes.byref(c_fps),
                               ctypes.byref(nf))
    if ret != 0:
        raise IOError(f"cannot open video: {path} (averror {ret})")
    try:
        if start_frame:
            ret = lib.eioku_video_seek(h, start_frame)
            if ret != 0:
                raise IOError(f"video seek failed: {path} (averror {ret})")
        emitted = 0
        while True:
            want = batch_size
            if max_frames is not None:
                want = min(want, max_frames - emitted)
                if want <= 0:
                    return
            buf = np.empty((batch_size, out_h.value, out_w.value, 3), np.uint8)
            idx = np.empty((batch_size,), np.int64)
            n = ctypes.c_int()
            ret = lib.eioku_video_read(
                h, step, want, end_frame,
                buf.ctypes.data_as(ctypes.c_char_p),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                ctypes.byref(n))
            valid = n.value
            if ret < 0:
                # hard mid-stream error: keep what decoded, like the cv2
                # path's `if not ok: break` — partial results beat a failed
                # task on a truncated recording
                log.warning("video decode error on %s (averror %d); "
                            "keeping %d frames of this read", path, ret, valid)
            if valid:
                buf[valid:] = 0
                indices = np.zeros((batch_size,), np.int32)
                indices[:valid] = idx[:valid]
                stamps = np.zeros((batch_size,), np.int32)
                stamps[:valid] = np.round(idx[:valid] / fps * 1000.0)
                yield FrameBatch(frames=buf, frame_indices=indices,
                                 timestamps_ms=stamps, valid=valid)
                emitted += valid
            if ret < 0 or (ret == 1 and valid < want):
                return
    finally:
        lib.eioku_video_close(h)


def _decode_native_list(path, fps, step, batch_size, resize_hw,
                        start_frame: int, end_frame: int,
                        fast_level: int = 0) -> list[FrameBatch]:
    """Stripe-worker entry point (one segment -> its batches)."""
    return list(_decode_native(path, fps, step, batch_size, resize_hw, None,
                               start_frame, end_frame, fast_level))


def probe(path: str) -> VideoInfo:
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        return VideoInfo(
            path=path,
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS)) or 30.0,
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
    finally:
        cap.release()


def iter_frame_batches(
    path: str,
    batch_size: int = 32,
    frame_interval_s: float = 1.0,
    resize_hw: tuple[int, int] | None = None,
    max_frames: int | None = None,
    decode_threads: int = 1,
    decode_procs: int = 0,
    fast_level: int = 0,
) -> Iterator[FrameBatch]:
    """Yield fixed-shape batches of frames sampled every `frame_interval_s`.

    Frames between samples are skipped with cap.grab() (no decode), matching the
    reference's skip strategy but emitting batches instead of single frames.
    decode_threads > 1 stripes the video across segment decoders (each with its
    own capture) — decode is the host-side bottleneck of the indexing pipeline.
    decode_procs > 0 uses a persistent spawn-based process pool instead, for
    multi-core hosts where cv2's GIL-released decode still contends with the
    Python consumer (frames are resized in the child, so IPC carries only the
    model-input geometry).
    fast_level (native path only) engages the analysis-decode accelerators:
    1 = skip the deblocking filter, 2 = additionally skip non-reference
    frames on sparse sampling grids (_decode_flags). Default 0 stays
    bit-exact with the cv2 path.
    """
    info = probe(path)
    step = max(int(round(info.fps * frame_interval_s)), 1)
    use_procs = decode_procs > 0
    if use_procs and resize_hw is None:
        # without a child-side downscale, IPC would carry full-resolution
        # batches (hundreds of MB in flight) — threads are strictly better
        use_procs = False
    n_workers = decode_procs if use_procs else decode_threads
    # striping only pays when cores exist to run the stripes: on a 1-core host
    # the thread variant measured ~13% slower than serial decode
    n_workers = min(n_workers, os.cpu_count() or 1)
    if n_workers > 1 and info.frame_count >= n_workers * step * 2 \
            and max_frames is None:
        yield from _iter_batches_striped(path, info, step, batch_size,
                                         resize_hw, n_workers,
                                         use_procs=use_procs,
                                         fast_level=fast_level)
        return
    if _native_enabled():
        yield from _decode_native(path, info.fps, step, batch_size,
                                  resize_hw, max_frames,
                                  fast_level=fast_level)
        return
    yield from _decode_segment(path, info.fps, step, batch_size, resize_hw,
                               max_frames, start_frame=0, end_frame=None)


def _decode_segment(path, fps, step, batch_size, resize_hw, max_frames,
                    start_frame: int, end_frame: int | None
                    ) -> Iterator[FrameBatch]:
    """Serial sampled decode of [start_frame, end_frame). Module-level and
    framework-free so spawn-based process-pool workers can run it."""
    cap = cv2.VideoCapture(path)
    try:
        if start_frame:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
        frames: list[np.ndarray] = []
        indices: list[int] = []
        stamps: list[int] = []
        emitted = 0
        frame_idx = start_frame
        while end_frame is None or frame_idx < end_frame:
            if max_frames is not None and emitted + len(frames) >= max_frames:
                break
            if frame_idx % step == 0:
                ok, frame = cap.read()
                if not ok:
                    break
                # resize first: the BGR->RGB pass then touches only the small
                # model-input frame instead of the full-res one
                if resize_hw is not None:
                    frame = cv2.resize(frame, (resize_hw[1], resize_hw[0]),
                                       interpolation=cv2.INTER_AREA)
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frames.append(frame)
                indices.append(frame_idx)
                stamps.append(int(round(frame_idx / fps * 1000.0)))
                if len(frames) == batch_size:
                    yield _make_batch(frames, indices, stamps, batch_size)
                    emitted += len(frames)
                    frames, indices, stamps = [], [], []
            else:
                if not cap.grab():
                    break
            frame_idx += 1
        if frames:
            yield _make_batch(frames, indices, stamps, batch_size)
    finally:
        cap.release()


def _decode_segment_list(path, fps, step, batch_size, resize_hw,
                         start_frame: int, end_frame: int) -> list[FrameBatch]:
    """Picklable entry point for process-pool workers."""
    return list(_decode_segment(path, fps, step, batch_size, resize_hw, None,
                                start_frame, end_frame))


_proc_pools: dict[int, object] = {}
_proc_pool_lock = threading.Lock()


def _get_proc_pool(n_workers: int):
    """Persistent spawn-based pools (spawn: never fork a live CUDA runtime),
    one per requested size, reused across videos to amortize child startup.
    Pools are never shut down while the process lives — a concurrent striped
    iterator may hold futures on any of them; distinct sizes come from task
    config values, so the dict stays tiny."""
    with _proc_pool_lock:
        pool = _proc_pools.get(n_workers)
        if pool is None:
            from concurrent.futures import ProcessPoolExecutor
            import multiprocessing as mp

            pool = ProcessPoolExecutor(
                max_workers=n_workers, mp_context=mp.get_context("spawn"))
            _proc_pools[n_workers] = pool
        return pool


def _iter_batches_striped(path, info, step, batch_size, resize_hw,
                          n_workers: int, use_procs: bool = False,
                          fast_level: int = 0) -> Iterator[FrameBatch]:
    """Stream the video as step-aligned segments decoded by a worker pool.

    Each segment spans step*batch_size source frames (= exactly one output
    batch), segments are dispatched n_workers+1 ahead and re-emitted strictly
    in time order, so memory stays bounded at a few batches regardless of video
    length. Segment starts are multiples of the sampling step, making the
    sampled frame set identical to the serial path.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    total = info.frame_count
    seg = step * batch_size
    segments = ((s, min(s + seg, total)) for s in range(0, total, seg))

    if use_procs:
        pool = _get_proc_pool(n_workers)
        submit = lambda rng: pool.submit(_decode_segment_list, path, info.fps,
                                         step, batch_size, resize_hw, *rng)
        owned = None
    else:
        # stripe workers use the native decoder when it's available: decode
        # runs with the GIL released, plus lowres/fused-convert per stripe
        use_native = _native_enabled()
        worker = _decode_native_list if use_native else _decode_segment_list
        owned = ThreadPoolExecutor(max_workers=n_workers)
        if use_native:
            submit = lambda rng: owned.submit(worker, path, info.fps, step,
                                              batch_size, resize_hw, *rng,
                                              fast_level)
        else:
            submit = lambda rng: owned.submit(worker, path, info.fps, step,
                                              batch_size, resize_hw, *rng)
    try:
        pending: deque = deque()
        for rng in segments:
            pending.append(submit(rng))
            if len(pending) > n_workers + 1:
                yield from pending.popleft().result()
        while pending:
            yield from pending.popleft().result()
    finally:
        if owned is not None:
            owned.shutdown(wait=False, cancel_futures=True)


def _make_batch(frames: list[np.ndarray], indices: list[int], stamps: list[int],
                batch_size: int) -> FrameBatch:
    valid = len(frames)
    h, w, c = frames[0].shape
    out = np.zeros((batch_size, h, w, c), dtype=np.uint8)
    out[:valid] = np.stack(frames)
    idx = np.zeros((batch_size,), dtype=np.int32)
    idx[:valid] = indices
    ts = np.zeros((batch_size,), dtype=np.int32)
    ts[:valid] = stamps
    return FrameBatch(frames=out, frame_indices=idx, timestamps_ms=ts, valid=valid)


def prefetch(iterator: Iterator[FrameBatch], depth: int = 2) -> Iterator[FrameBatch]:
    """Run decode on a background thread so host decode overlaps device compute
    (double-buffered host staging, SURVEY.md hard-part 5)."""
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    _sentinel = object()
    error: list[BaseException] = []

    def producer() -> None:
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate decode errors to consumer
            error.append(e)
        finally:
            q.put(_sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _sentinel:
            if error:
                raise error[0]
            return
        yield item
