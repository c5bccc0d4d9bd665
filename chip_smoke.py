"""Smoke run of the PyTorch/CUDA port (eioku_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line) on error:

1. environment: the card's name and power limit, torch and CUDA versions;
   builds every kernel of the path from csrc/ (one nvcc per source, started
   together) and prints the build time and ptxas' resource report;
2. K1 scene-diff kernel against its plain PyTorch version on the card, at the
   main path's chain shape [257, 46080] and a ragged one (odd N, D not a
   multiple of 4): max abs error <= 1e-6, then kernel / plain / library time
   over four main-path chains cycled, so that L2 never holds the next input;
3. K2 NMS keep-mask kernel against its plain version at B = 64,
   K in {256, 300, 512, 1024} with padding tails: keep masks exactly equal;
4. the slice: InferenceEngine(device="cuda").run_task("visual_analysis")
   with scenes + YOLOv8n (full published width, random weights from seed 0,
   bf16) over a 60 s 1280x720 30 fps clip with planted colour cuts. The
   launch counts are zeroed just before the measured run and read just after;
   both kernels must have launched. The scene count must equal the cuts + 1,
   object rows must be finite, and the scene rows must equal those of the
   port's CPU path on the same clip; YOLOv8n fp32 logits on the card (TF32
   off) must agree with the CPU's on a small batch. A second run takes
   top_k = 1024 (the K > max_det NMS route);
5. one JSON line {"kernels": [...]} with each kernel's launches in the
   measured run, max error, kernel / plain / bound / library times;
6. the card's name and power limit (nvidia-smi), then, as the last line,
   {"ok": true, "device": {...}}.

Without CUDA, or outside a checkout of the repository, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
K1_SHAPE = (257, 96 * 160 * 3)  # SCENE_CHUNK + 1 carried plane, D = 96*160*3
K1_RAGGED = (67, 1001)
K1_TIMING_CHAINS = 4
K2_BATCH = 64
K2_KS = (256, 300, 512, 1024)
K2_MAIN_K = 256  # detect()'s default top_k
CLIP_W, CLIP_H, CLIP_FPS, CLIP_SECONDS = 1280, 720, 30, 60
CUT_EVERY_S = 10  # 6 colour segments -> 5 planted cuts


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5, args=((),)) -> float:
    """Mean device time of fn(*a) over `iters` back-to-back calls (CUDA
    events), cycling through the argument tuples in `args`: inputs larger
    than the 50 MB L2 together make every call read device memory."""
    import torch

    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args[i % len(args)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    from eioku_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()  # every source is stale in a fresh checkout
    each = ", ".join("%s %.2f s" % (n, b["seconds"]) for n, b in built.items())
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall ({each or 'up to date'})")
    for name, b in built.items():
        for line in b["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"  {name}: {line.strip()}")
    for name in _cuda.KERNELS:
        _cuda.load(name)
    return built


def phase_k1(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.scene_diff import pair_diff, pair_diff_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {}
    for n, d in (K1_SHAPE, K1_RAGGED):
        chain = torch.rand((n, d), generator=gen, device=dev)
        got = pair_diff(chain)
        want = pair_diff_plain(chain)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f"K1 scene_diff [{n}, {d}]: max abs err {err:.3e}")
        if not err <= 1e-6:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"[{n}, {d}]: {err}")
        if (n, d) != K1_SHAPE:
            continue
        # four chains (190 MB) cycled, so that no call finds its 47 MB chain
        # left in L2 by the call before
        chains = [(chain,)] + [(torch.rand((n, d), generator=gen, device=dev),)
                               for _ in range(K1_TIMING_CHAINS - 1)]
        ms = cuda_ms(pair_diff, args=chains)
        plain_ms = cuda_ms(pair_diff_plain, args=chains)
        library_ms = cuda_ms(
            lambda c: F.pairwise_distance(c[:-1], c[1:], p=1.0, eps=0.0),
            args=chains)
        nbytes = n * d * 4 + (n - 1) * 4
        ops = 3 * (n - 1) * d  # sub, abs, add per element pair
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "library_ms": library_ms}
        log(f"K1 [{n}, {d}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"pairwise_distance {library_ms:.4f} ms, bound {result['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")
    return result


def _nms_workload(b: int, k: int, seed: int, pad_from: int):
    """Score-sorted candidates as in tests/test_nms_kernel.py, with a tail of
    zero-score padding."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (b, k, 2))
    wh = rng.uniform(5, 40, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.1, 1.0, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    scores[:, pad_from:] = 0.0
    classes = rng.integers(0, 3, (b, k)).astype(np.int32)
    return boxes, scores, classes


def _nms_pair_ops(keep: np.ndarray, scores: np.ndarray,
                  classes: np.ndarray) -> int:
    """IoU tests the greedy order needs on this data: for each kept i, the
    valid same-class j > i (about 14 fp32 operations each)."""
    total = 0
    for b in range(keep.shape[0]):
        valid = scores[b] > 0
        for i in np.nonzero(keep[b])[0]:
            total += int(np.count_nonzero(valid[i + 1:]
                                          & (classes[b, i + 1:] == classes[b, i])))
    return 14 * total


def phase_k2(dev) -> dict:
    import torch

    from eioku_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain

    result = {}
    for k in K2_KS:
        bx, sc, cl = _nms_workload(K2_BATCH, k, seed=k, pad_from=k - k // 5)
        boxes = torch.from_numpy(bx).to(dev)
        scores = torch.from_numpy(sc).to(dev)
        classes = torch.from_numpy(cl).to(dev)
        got = nms_keep_mask(boxes, scores, classes, 0.45)
        want = nms_keep_mask_plain(boxes, scores, classes, 0.45)
        mismatches = int((got != want).sum())
        kept = int(want.sum())
        log(f"K2 nms [B={K2_BATCH}, K={k}]: {kept} kept, {mismatches} mismatches")
        if mismatches:
            raise AssertionError(f"K2 keep mask differs from its plain version "
                                 f"at K={k} in {mismatches} slots")
        ms = cuda_ms(lambda: nms_keep_mask(boxes, scores, classes, 0.45))
        plain_ms = cuda_ms(lambda: nms_keep_mask_plain(boxes, scores, classes, 0.45),
                           iters=5, warmup=1)
        nbytes = K2_BATCH * k * (16 + 4 + 4 + 1)
        ops = _nms_pair_ops(want.cpu().numpy(), sc, cl)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        log(f"K2 [B={K2_BATCH}, K={k}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {max(t_bytes, t_ops):.5f} ms")
        if k == K2_MAIN_K:
            result = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": None}
    return result


def write_clip(path: str) -> int:
    """A 1280x720 mp4v clip of solid colour segments with per-pixel noise and
    a moving block; returns the number of planted cuts."""
    import cv2

    colors = [(200, 40, 40), (40, 200, 40), (40, 40, 220), (220, 220, 60),
              (30, 30, 30), (200, 60, 200)]
    n_frames = CLIP_SECONDS * CLIP_FPS
    seg = CUT_EVERY_S * CLIP_FPS
    rng = np.random.default_rng(0)
    noise = [rng.integers(-4, 5, (CLIP_H, CLIP_W, 3)) for _ in range(4)]
    # per colour: a few noisy uint8 frames, cycled (BGR for cv2)
    bases = [[np.clip(np.array((b, g, r)) + n, 0, 255).astype(np.uint8)
              for n in noise] for r, g, b in colors]
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), CLIP_FPS,
                        (CLIP_W, CLIP_H))
    if not w.isOpened():
        raise RuntimeError("cv2.VideoWriter (mp4v) could not open " + path)
    try:
        for f in range(n_frames):
            frame = bases[(f // seg) % len(colors)][f % len(noise)].copy()
            x = (f * 7) % (CLIP_W - 200)
            frame[260:460, x:x + 200] = 255 - frame[260:460, x:x + 200]
            w.write(frame)
    finally:
        w.release()
    return n_frames // seg - 1


def _check_object_rows(rows: list[dict]) -> None:
    for r in rows:
        p = r["payload"]
        vals = [p["confidence"], *p["bounding_box"].values()]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite object row {r}")


def phase_slice(dev, workdir: str) -> dict:
    import torch

    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda

    clip = os.path.join(workdir, "clip.mp4")
    t0 = time.perf_counter()
    cuts = write_clip(clip)
    log(f"clip: {CLIP_W}x{CLIP_H} {CLIP_FPS} fps {CLIP_SECONDS} s, {cuts} cuts, "
        f"written in {time.perf_counter() - t0:.1f} s")
    engine = InferenceEngine(device="cuda")
    config = {"scene_detection": {}, "object_detection": {"batch_size": 64}}

    def run(cfg: dict, label: str) -> tuple[dict, float]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = engine.run_task("visual_analysis", clip, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        log(f"slice {label}: {wall:.3f} s wall, {CLIP_SECONDS / wall:.2f} video-s/s, "
            f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
            f"{len(out['scene_detection'])} scenes, "
            f"{len(out['object_detection'])} object rows")
        return out, wall

    run(config, "warm-up")  # loads the model, initialises cuDNN
    _cuda.reset_launch_counts()
    out, wall = run(config, "measured")
    launches = _cuda.launch_counts()
    log(f"launches in the measured run: {launches}")
    for name in _cuda.KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the main path never launched {name}")
    if len(out["scene_detection"]) != cuts + 1:
        raise AssertionError(f"expected {cuts + 1} scenes, got "
                             f"{out['scene_detection']}")
    _check_object_rows(out["object_detection"])

    _cuda.reset_launch_counts()
    big, _ = run({**config, "object_detection": {"batch_size": 64, "top_k": 1024}},
                 "top_k=1024")
    if _cuda.launch_counts()["nms"] < 1:
        raise AssertionError("the top_k=1024 route never launched the NMS kernel")
    _check_object_rows(big["object_detection"])

    # reference: the port's CPU path (plain versions) gives the same scenes
    cpu_scenes = InferenceEngine(device="cpu").run_task(
        "visual_analysis", clip, {"scene_detection": {}})["scene_detection"]
    if cpu_scenes != out["scene_detection"]:
        raise AssertionError(f"scene rows differ from the CPU path:\n"
                             f"{cpu_scenes}\n{out['scene_detection']}")
    log("scene rows equal the CPU path's")
    return {"launches": launches, "wall_s": wall,
            "video_s_per_s": CLIP_SECONDS / wall,
            "scenes": len(out["scene_detection"]),
            "object_rows": len(out["object_detection"])}


def phase_logits_reference(dev) -> None:
    """YOLOv8n at fp32 on the card (TF32 off) against the CPU on 2 frames."""
    import torch

    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm

    torch.backends.cudnn.allow_tf32 = False  # fp32 comparison: no TF32 convs
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = fold_batchnorm(YOLOv8(YoloConfig("yolov8n"),
                                      generator=torch.Generator().manual_seed(0))).eval()
        x = torch.rand((2, 3, 384, 640), generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            ref = model(x)
            got = model.to(dev)(x.to(dev))
        for name, r, g in zip(("box", "cls"), ref, got):
            err = float((g.cpu() - r).abs().max())
            scale = float(r.abs().max())
            log(f"yolov8n fp32 {name} logits card vs CPU: max abs err {err:.3e} "
                f"(max |logit| {scale:.3e})")
            if not err <= 1e-4 * max(scale, 1.0):
                raise AssertionError(f"{name} logits differ: {err} vs scale {scale}")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAILED: torch.cuda.is_available() is false; this smoke run needs a GPU")
        return 2
    try:
        import eioku_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"FAILED: eioku_tpu_torch is not importable ({e}); run from a checkout")
        return 2
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    phase_logits_reference(dev)
    with tempfile.TemporaryDirectory(prefix="eioku_smoke_") as workdir:
        sl = phase_slice(dev, workdir)
    kernels = [
        {"name": "scene_diff", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/scene_diff.cu",
         "replaces": "eioku_tpu/ops/scene_diff.py:32",
         "launches": sl["launches"]["scene_diff"], **k1},
        {"name": "nms_keep", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/nms.cu",
         "replaces": "eioku_tpu/ops/nms.py:30",
         "launches": sl["launches"]["nms"], **k2},
    ]
    print(json.dumps({"slice": {k: v for k, v in sl.items() if k != "launches"}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # any failed phase fails the run, with its traceback
        import traceback

        traceback.print_exc()
        log(f"FAILED: {type(e).__name__}: {e}")
        code = 1
    sys.exit(code)
