"""Smoke run of the PyTorch/CUDA port (eioku_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line) on error:

1. environment: the card's name and power limit, torch and CUDA versions;
   builds every kernel of the path from csrc/ (one nvcc per source, started
   together) and prints the build time and ptxas' resource report; counts
   the HGMMA (wgmma) and UTMALDG (TMA load) instructions in K3's library
   (cuobjdump --dump-sass) and fails if either is 0, or if ptxas reports a
   spill in K3's bf16 kernel or in K2's two kernels (mask and scan);
2. K1 scene-diff kernel against its plain PyTorch version on the card, at the
   main path's chain shape [257, 46080] and a ragged one (odd N, D not a
   multiple of 4): max abs error <= 1e-6, then kernel / plain / library time
   over four main-path chains cycled, so that L2 never holds the next input;
3. K2 NMS keep-mask kernel against its plain version at B = 64,
   K in {256, 300, 512, 1024} with padding tails: keep masks exactly equal;
   times over back-to-back calls at every K and, at K = 256 and 1024, also
   replayed from a CUDA graph (the gap is the wrapper's host cost), beside
   the launch floor: an empty kernel's graph-replayed time;
3b. K3 flash-attention kernel against its plain version at the Whisper
   large-v3 encoder's [4, 20, 1500, 64] in bf16 and f32, causal
   [2, 4, 200, 64] f32, MiniLM's [2, 12, 512, 32] bf16 with lengths
   [512, 130], and rows of length 0 (zeros, no NaN). fp32: 2e-5 absolute;
   bf16: 1 bf16 ulp of the plain version (fp32 from the same bf16 inputs,
   rounded once) plus 2^-8 * sum_j p_j |v_j|, since the kernel rounds P to
   bf16 once before P V (csrc/flash_attention.cu). Then kernel / plain /
   bound / scaled_dot_product_attention times at the encoder's shape, and
   kernel / bound / scaled_dot_product_attention (with a key mask) at
   MiniLM's, there both over back-to-back calls and replayed from a CUDA
   graph (device time without the host's), each with the kernel's share of
   its bound and its ratio to the library time;
4. the visual slice: InferenceEngine(device="cuda").run_task("visual_analysis")
   with scenes + YOLOv8n (full published width, random weights from seed 0,
   bf16) over a 60 s 1280x720 30 fps clip with planted colour cuts. The
   launch counts are zeroed just before the measured run and read just after;
   both kernels must have launched. The candidates that run hands to the
   NMS (YOLOv8n's top 256 at 80 classes) are kept, and the kernel's keep
   masks on them must equal the plain version's exactly; so on the
   top_k = 1024 run below. The scene count must equal the cuts + 1,
   object rows must be finite, and the scene rows must equal those of the
   port's CPU path on the same clip; YOLOv8n fp32 logits on the card (TF32
   off) must agree with the CPU's on a small batch. A run of the
   object_detection task takes top_k = 1024 (the K > max_det NMS route);
4b. transcription at full width: a 150 s 16 kHz wav of five 30 s windows,
   window 2 digitally silent (the energy VAD drops it: 4 windows, one
   batch), through run_task("transcription") with Whisper large-v3 (random
   weights from seed 0, bf16), batch 4, 224 tokens: a warm-up, then a
   measured run whose K3 launches must be 32 x its encoder calls and whose
   result must be [] (random weights emit no rows, as in the JAX package);
4c. production decode at full width: whisper_decode_windows, beam 5, 224
   tokens with EOT suppressed, on the encoder output of those 4 windows;
4d. card against CPU on the pretrained path: a random tiny tree (seed 0)
   saved as whisper-tiny.npz in OpenAI naming, transcribed on the card (TF32
   off) and on the CPU in fp32 with beam 5 and timestamps: encoder states
   within 1e-3 and rows equal (where tokens first differ, the CPU's top-2
   log-prob margin there must be below 1e-3); once more with the
   temperature ladder on;
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
import re
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
K2_BIG_K = 1024  # object_detection with top_k = 1024 (the K > max_det route)
CLIP_W, CLIP_H, CLIP_FPS, CLIP_SECONDS = 1280, 720, 30, 60
CUT_EVERY_S = 10  # 6 colour segments -> 5 planted cuts
VISUAL_KERNELS = ("scene_diff", "nms")  # K1, K2: the visual pass's kernels
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
K3_SHAPE = (4, 20, 1500, 64)  # Whisper large-v3 encoder, batch 4
K3_MINILM = ((2, 12, 512, 32), (512, 130))  # MiniLM's route: shape, lengths
K3_CASES = (  # shape, dtype name, causal, lengths
    (K3_SHAPE, "bfloat16", False, None),
    (K3_SHAPE, "float32", False, None),
    ((2, 4, 200, 64), "float32", True, None),
    ((2, 12, 512, 32), "bfloat16", False, (512, 130)),
    ((2, 2, 77, 32), "float32", False, (0, 77)),
    ((2, 2, 130, 64), "bfloat16", True, (0, 100)),
)
AUDIO_SECONDS, SILENT_WINDOW = 150, 2  # five 30 s windows, window 2 silent
WHISPER_CONFIG = {"model": "large-v3", "random_full_size": True,
                  "batch_size": 4, "max_tokens": 224}
TINY_CONFIG = {"model": "tiny", "language": "en", "compute_dtype": "float32",
               "temperatures": [], "max_tokens": 32, "no_speech_threshold": 2.0}
TOKEN_MARGIN_TOL = 1e-3  # CPU top-2 log-prob gap where card and CPU part
ENC_TOL = 1e-3  # tiny encoder, fp32 card (TF32 off) vs CPU


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


def _spills(ptxas_log: str, entries: tuple[str, ...]) -> list[str]:
    """ptxas' spill lines for the kernels named in `entries` that spill."""
    bad, watched = [], False
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            watched = any(e in line for e in entries)
        elif watched and "spill stores" in line:
            stores, loads = (int(x) for x in re.findall(r"(\d+) bytes spill", line))
            if stores or loads:
                bad.append(line.strip())
    return bad


def cuda_graph_ms(fn, args, iters: int = 20, replays: int = 10) -> float:
    """Mean device time of fn(*a) with the host taken out: `iters` calls,
    cycling through `args`, captured once in a CUDA graph and replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for a in args:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(*args[i % len(args)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def phase_build() -> dict:
    from eioku_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()  # every source is stale in a fresh checkout
    each = ", ".join("%s %.2f s" % (n, b["seconds"]) for n, b in built.items())
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall ({each or 'up to date'})")
    for name, b in built.items():
        for line in b["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line) \
                    or "spill stores" in line:
                log(f"  {name}: {line.strip()}")
    for name in _cuda.KERNELS:
        _cuda.load(name)
    for name, label, entries in (
            ("flash_attention", "K3's bf16 kernels", ("flash_bf16_hopper",)),
            ("nms", "K2's kernels", ("nms_mask_kernel", "nms_scan_kernel"))):
        if name not in built:
            log(f"{label} were built before this run: their ptxas report is not checked")
            continue
        spills = _spills(built[name]["log"], entries)
        if spills:
            raise AssertionError(f"{label} spill: {spills}")
        log(f"{label}: no spills in ptxas' report")
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", _cuda._lib_path("flash_attention")],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
    log(f"K3 SASS: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG instructions")
    if not all(counts.values()):
        raise AssertionError(f"K3 has no wgmma or no TMA load in its SASS: {counts}")
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


def _nms_workload(b: int, k: int, seed: int, pad_from: int, n_classes: int = 3):
    """Score-sorted candidates as in tests/test_nms_kernel.py, with a tail of
    zero-score padding."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (b, k, 2))
    wh = rng.uniform(5, 40, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.1, 1.0, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    scores[:, pad_from:] = 0.0
    classes = rng.integers(0, n_classes, (b, k)).astype(np.int32)
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


def launch_floor_ms() -> float:
    """Graph-replayed time of one empty kernel: the least a launch costs."""
    import torch

    from eioku_tpu_torch.ops import _cuda

    lib = _cuda.load("nms")

    def empty():
        if lib.eioku_empty_launch(torch.cuda.current_stream().cuda_stream):
            raise AssertionError("the empty kernel did not launch")
    return cuda_graph_ms(empty, args=((),))


def phase_k2(dev) -> dict:
    import torch

    from eioku_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain

    floor_ms = launch_floor_ms()
    log(f"launch floor: an empty kernel replayed from a CUDA graph takes "
        f"{floor_ms:.5f} ms (K2 launches two kernels a call)")
    result = {"launch_floor_ms": floor_ms}
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
        kernel = lambda: nms_keep_mask(boxes, scores, classes, 0.45)  # noqa: E731
        ms = cuda_ms(kernel)
        graph_ms = cuda_graph_ms(kernel, args=((),)) if k in (K2_MAIN_K, K2_BIG_K) else None
        plain_ms = cuda_ms(lambda: nms_keep_mask_plain(boxes, scores, classes, 0.45),
                           iters=5, warmup=1)
        nbytes = K2_BATCH * k * (16 + 4 + 4 + 1)
        ops = _nms_pair_ops(want.cpu().numpy(), sc, cl)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        log(f"K2 [B={K2_BATCH}, K={k}]: kernel {ms:.5f} ms (calls)"
            + ("" if graph_ms is None else f", {graph_ms:.5f} ms (graph)")
            + f", plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms")
        if k == K2_MAIN_K:
            result.update({"max_abs_err": 0.0, "ms": ms, "cuda_graph_ms": graph_ms,
                           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                           "library_ms": None})
        elif k == K2_BIG_K:
            result.update({"ms_k1024": ms, "cuda_graph_ms_k1024": graph_ms})
    return result


def bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def k3_error(got, want, cancel) -> float:
    """fp32: max abs error. bf16: the largest (error - 1 ulp - 2^-8 *
    sum_j p_j |v_j|) over elements, <= 0 when within tolerance."""
    import torch

    if got.dtype != want.dtype:
        raise AssertionError("kernel and plain version differ in type")
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float(diff.max())
    ulp = bf16_ulp(got.float().abs().maximum(want.float().abs()))
    return float((diff - ulp - 2.0 ** -8 * cancel).max())


def phase_k3(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    result = {}
    for shape, dtype_name, causal, lengths in K3_CASES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(shape[2])
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                         device=dev)
        got = flash_attention(q, k, v, lengths=lens, causal=causal)
        want = flash_attention_plain(q, k, v, lengths=lens, causal=causal)
        cancel = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       lengths=lens, causal=causal)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K3 {shape} {dtype_name}: non-finite output")
        if lengths is not None and lengths[0] == 0 and bool(got[0].any()):
            raise AssertionError(f"K3 {shape}: a row with no valid key is not zero")
        err = k3_error(got, want, cancel)
        max_abs = float((got.float() - want.float()).abs().max())
        tol = 2e-5 if dtype == torch.float32 else 0.0
        log(f"K3 flash_attention {list(shape)} {dtype_name} causal={causal} "
            f"lengths={lengths}: max abs err {max_abs:.3e}"
            + ("" if dtype == torch.float32 else f", excess over 1 ulp + 2^-8 "
               f"sum p|v| {err:.3e}"))
        if not err <= tol:
            raise AssertionError(f"K3 disagrees with its plain version at {shape} "
                                 f"{dtype_name}: {err}")
        if (shape, dtype_name) == (K3_SHAPE, "bfloat16"):
            result["max_abs_err"] = max_abs
    # timing at the encoder's shape and layout: [B, S, H, D] projections
    # viewed as [B, H, S, D]; two input sets (2 x 46 MB) cycled past the L2
    b, h, s_len, d = K3_SHAPE
    gen = torch.Generator(device=dev).manual_seed(7)
    sets = [tuple(torch.randn((b, s_len, h, d), generator=gen, device=dev)
                  .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
            for _ in range(2)]
    ms = cuda_ms(flash_attention, iters=30, args=sets)
    plain_ms = cuda_ms(flash_attention_plain, iters=5, warmup=1, args=sets)
    library_ms = cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, scale=d ** -0.5), iters=30, args=sets)
    nbytes = 4 * b * h * s_len * d * 2  # q, k, v read once, o written once
    ops = 4 * b * h * s_len * s_len * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    result.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": library_ms})
    log(f"K3 {list(K3_SHAPE)} bf16: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"scaled_dot_product_attention {library_ms:.5f} ms, bound "
        f"{result['bound_ms']:.5f} ms ({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"{result['bound_ms'] / ms:.1%} of the bound, {ms / library_ms:.3f}x the "
        f"library time")
    phase_k3_minilm(dev)
    return result


def phase_k3_minilm(dev) -> None:
    """K3 at MiniLM's route, [2, 12, 512, 32] bf16 with lengths [512, 130],
    against scaled_dot_product_attention with the same key mask. The bound
    counts what these lengths need: keys and values up to each length."""
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.flash_attention import flash_attention

    (b, h, s_len, d), lengths = K3_MINILM
    gen = torch.Generator(device=dev).manual_seed(11)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mask = (torch.arange(s_len, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    sets = [tuple(torch.randn((b, h, s_len, d), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3)) for _ in range(4)]
    kernel = lambda q, k, v: flash_attention(q, k, v, lengths=lens)  # noqa: E731
    library = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, scale=d ** -0.5)
    keys = sum(lengths)
    ops = 4 * h * s_len * keys * d
    nbytes = 2 * (2 * b * h * s_len * d + 2 * h * keys * d)  # q, o; k, v to each length
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    # back-to-back calls (what an eager caller waits for; the host's share
    # shows at this size), then device time from a replayed CUDA graph
    for how, timer in (("calls", cuda_ms), ("graph", cuda_graph_ms)):
        ms, library_ms = timer(kernel, args=sets), timer(library, args=sets)
        log(f"K3 MiniLM {[b, h, s_len, d]} bf16 lengths {list(lengths)} ({how}): kernel "
            f"{ms:.5f} ms, scaled_dot_product_attention (key mask) {library_ms:.5f} ms, "
            f"bound {bound_ms:.5f} ms ({ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); "
            f"{bound_ms / ms:.1%} of the bound, {ms / library_ms:.3f}x the library time")


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


def _capture_nms(postprocess) -> list:
    """Wrap postprocess.nms_keep_mask so that each call appends its inputs
    and the keep mask it returned; the caller puts the original back."""
    calls, fn = [], postprocess.nms_keep_mask

    def captured(boxes, scores, classes, iou_threshold=0.45):
        keep = fn(boxes, scores, classes, iou_threshold)
        calls.append((boxes, scores, classes, iou_threshold, keep))
        return keep
    postprocess.nms_keep_mask = captured
    return calls


def _check_captured_nms(calls: list, k: int, label: str) -> None:
    """The kernel's keep masks on the candidates a run handed to the NMS
    equal the plain version's on the same tensors, exactly."""
    from eioku_tpu_torch.ops.nms import nms_keep_mask_plain

    if not calls:
        raise AssertionError(f"{label}: no NMS call was captured")
    for boxes, scores, classes, thr, keep in calls:
        if boxes.shape[1] != k or not boxes.is_cuda:
            raise AssertionError(f"{label}: NMS got {tuple(boxes.shape)} on "
                                 f"{boxes.device}, expected K = {k} on the card")
        want = nms_keep_mask_plain(boxes, scores, classes, thr)
        mismatches = int((keep != want).sum())
        valid = scores > 0
        log(f"{label}: NMS on the run's candidates [B={boxes.shape[0]}, K={k}]: "
            f"{int(valid.sum())} valid, {int(want.sum())} kept, "
            f"{int(classes[valid].unique().numel())} classes, {mismatches} mismatches")
        if mismatches:
            raise AssertionError(f"{label}: K2's keep mask differs from the plain "
                                 f"version's on the run's candidates in {mismatches} slots")


def phase_slice(dev, workdir: str) -> dict:
    import torch

    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.yolo import postprocess
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
    nms_keep_mask = postprocess.nms_keep_mask
    try:
        calls = _capture_nms(postprocess)
        _cuda.reset_launch_counts()
        out, wall = run(config, "measured")
        launches = _cuda.launch_counts()
        log(f"launches in the measured run: {launches}")
        _check_captured_nms(calls, K2_MAIN_K, "visual_analysis")

        # the K > max_det NMS route, on the task that honours top_k (the
        # combined pass, like the JAX package's, ignores it)
        calls = _capture_nms(postprocess)
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        big = engine.run_task("object_detection", clip,
                              {"batch_size": 64, "top_k": K2_BIG_K})
        torch.cuda.synchronize()
        big_s = time.perf_counter() - t
        big_launches = _cuda.launch_counts()["nms"]
        _check_captured_nms(calls, K2_BIG_K, f"object_detection top_k={K2_BIG_K}")
    finally:
        postprocess.nms_keep_mask = nms_keep_mask
    for name in VISUAL_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the visual pass never launched {name}")
    if len(out["scene_detection"]) != cuts + 1:
        raise AssertionError(f"expected {cuts + 1} scenes, got "
                             f"{out['scene_detection']}")
    _check_object_rows(out["object_detection"])
    if big_launches < 1:
        raise AssertionError("the top_k=1024 route never launched the NMS kernel")
    _check_object_rows(big)
    log(f"object_detection top_k={K2_BIG_K}: {big_s:.3f} s, {len(big)} rows")

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


def write_speech_wav(path: str) -> None:
    """AUDIO_SECONDS of 16 kHz mono: a gliding tone with noise in every 30 s
    window except SILENT_WINDOW, which is digitally silent."""
    import wave

    sr = 16000
    rng = np.random.default_rng(0)
    t = np.arange(sr * AUDIO_SECONDS) / sr
    x = 0.3 * np.sin(2 * np.pi * (180 + 40 * np.sin(0.5 * t)) * t) \
        + 0.05 * rng.standard_normal(t.shape)
    x[SILENT_WINDOW * 30 * sr:(SILENT_WINDOW + 1) * 30 * sr] = 0.0
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _count_calls(module, name: str) -> list:
    """Wrap module.name so that each call appends to the returned list."""
    calls, fn = [], getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    setattr(module, name, counted)
    return calls


def phase_transcription(dev, wav: str) -> dict:
    import torch

    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.whisper.model import WhisperConfig
    from eioku_tpu_torch.ops import _cuda

    n_layers = WhisperConfig(WHISPER_CONFIG["model"]).n_enc_layers
    engine = InferenceEngine(device=dev)
    enc_calls = _count_calls(transcribe, "whisper_encode")

    def run(label: str) -> tuple[list, float]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = engine.run_task("transcription", wav, WHISPER_CONFIG)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        log(f"transcription {label}: {wall:.3f} s wall, "
            f"{AUDIO_SECONDS / wall:.2f} audio-s/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, {len(out)} rows")
        return out, wall

    run("warm-up")  # random large-v3 init on the card, cuBLAS handles
    enc_calls.clear()
    _cuda.reset_launch_counts()
    out, wall = run("measured")
    launches = _cuda.launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"launches in the measured transcription: {launches}; "
        f"{len(enc_calls)} encoder calls")
    if launches["flash_attention"] != n_layers * len(enc_calls) or not enc_calls:
        raise AssertionError(f"K3 launched {launches['flash_attention']} times for "
                             f"{len(enc_calls)} encoder calls of {n_layers} layers")
    if out != []:
        raise AssertionError(f"random weights must emit no rows, got {out[:3]}")
    return {"launches": launches, "wall_s": wall,
            "audio_s_per_s": AUDIO_SECONDS / wall, "peak_mib": peak_mib,
            "encoder_calls": len(enc_calls)}


def phase_production_decode(dev, wav: str) -> dict:
    """whisper_decode_windows at large-v3, beam 5, 224 tokens, EOT suppressed
    (every row pays all 224 positions), on the 4 voiced windows."""
    import torch

    from eioku_tpu_torch.ml import audio_io, transcribe
    from eioku_tpu_torch.models.whisper.decoding import (
        build_suppress_masks,
        whisper_decode_windows,
    )
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import whisper_encode
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    model, cfg, _ = transcribe._load_model(
        WHISPER_CONFIG["model"], None, "bfloat16", WHISPER_CONFIG["random_full_size"],
        dev)
    windows = audio_io.split_windows(audio_io.load_wav(wav))
    mel = log_mel_spectrogram(torch.from_numpy(np.stack([w for _, w in windows]))
                              .to(dev), n_mels=cfg.n_mels)
    enc = whisper_encode(model, mel)
    tk = WhisperTokens(cfg.vocab_size)
    sot = tk.sot_sequence("en")
    init = torch.tensor([sot] * len(windows), device=dev)
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    sup_a[tk.eot] = True
    max_len = WHISPER_CONFIG["max_tokens"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, avg_lp, _ = whisper_decode_windows(model, enc, init, sup_a, sup_b,
                                            max_len=max_len, beam_size=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if not bool(torch.isfinite(avg_lp).all()) or bool((out[:, len(sot):] == tk.eot).any()):
        raise AssertionError("production decode: non-finite scores or an EOT")
    tokens = len(windows) * (max_len - len(sot))
    audio_s = 30.0 * len(windows)
    log(f"production decode {cfg.variant} beam 5, {len(windows)} windows x "
        f"{max_len - len(sot)} tokens: {wall:.3f} s, {audio_s / wall:.2f} audio-s/s, "
        f"{tokens / wall:.1f} decoded tokens/s")
    return {"wall_s": wall, "audio_s_per_s": audio_s / wall,
            "tokens_per_s": tokens / wall, "windows": len(windows)}


def _first_divergence_margin(cpu_model, card_model, wav: str, dev) -> float:
    """Where the CPU's and the card's decoded tokens first part: the CPU's
    top-2 log-prob margin at that step (decode_full on the CPU's prefix)."""
    import torch

    from eioku_tpu_torch.ml import audio_io
    from eioku_tpu_torch.models.whisper.decoding import (
        build_suppress_masks,
        whisper_decode_windows,
    )
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import (
        whisper_decode_full,
        whisper_encode,
    )
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    tk = WhisperTokens(cpu_model.cfg.vocab_size)
    wavs = torch.from_numpy(np.stack([w for _, w in audio_io.split_windows(
        audio_io.load_wav(wav))]))
    sot = tk.sot_sequence("en", timestamps=True)
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    rows = {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")),
                           ("card", card_model, dev)):
        enc = whisper_encode(model, log_mel_spectrogram(wavs.to(d), 80))
        init = torch.tensor([sot] * len(wavs), device=d)
        rows[name] = whisper_decode_windows(
            model, enc, init, sup_a, sup_b, max_len=TINY_CONFIG["max_tokens"],
            beam_size=5)[0].cpu()
        if name == "cpu":
            cpu_enc = enc
    diff = (rows["cpu"] != rows["card"]).nonzero()
    if len(diff) == 0:
        return 0.0
    w, p = (int(v) for v in diff[0])
    logits = whisper_decode_full(cpu_model, rows["cpu"][w:w + 1, :p], cpu_enc[w:w + 1])
    lp = torch.log_softmax(logits[0, -1].masked_fill(sup_a, -1e30), dim=-1)
    top2 = lp.topk(2).values
    margin = float(top2[0] - top2[1])
    log(f"card and CPU tokens first part in window {w} at position {p}: "
        f"CPU {int(rows['cpu'][w, p])}, card {int(rows['card'][w, p])}; "
        f"CPU top-2 log-prob margin there {margin:.3e}")
    return margin


def phase_card_vs_cpu(dev, wav: str, workdir: str) -> dict:
    import torch

    from eioku_tpu_torch.ml import audio_io, transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import (
        WhisperConfig,
        init_whisper,
        whisper_encode,
    )
    from eioku_tpu_torch.models.whisper.weights import load_whisper_checkpoint

    cache = os.path.join(workdir, "models")
    os.makedirs(cache)
    cfg = WhisperConfig("tiny")
    tree = init_whisper(cfg, torch.Generator().manual_seed(0))
    np.savez(os.path.join(cache, "whisper-tiny.npz"),
             **{k: v.detach().numpy() for k, v in tree.state_dict().items()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        path = os.path.join(cache, "whisper-tiny.npz")
        cpu_model = load_whisper_checkpoint(path, cfg, "cpu")
        card_model = load_whisper_checkpoint(path, cfg, dev)
        wav0 = torch.from_numpy(audio_io.split_windows(audio_io.load_wav(wav))[0][1])
        mel = log_mel_spectrogram(wav0[None], 80)
        enc_cpu = whisper_encode(cpu_model, mel)
        enc_card = whisper_encode(card_model, mel.to(dev)).cpu()
        enc_err = float((enc_card - enc_cpu).abs().max())
        log(f"tiny fp32 encoder states card vs CPU: max abs err {enc_err:.3e} "
            f"(max |state| {float(enc_cpu.abs().max()):.3e})")
        if not enc_err <= ENC_TOL:
            raise AssertionError(f"encoder states differ: {enc_err}")
        transcribe._load_model.cache_clear()
        rows = {}
        for name in ("cuda", "cpu"):
            t = time.perf_counter()
            rows[name] = InferenceEngine(model_cache_dir=cache, device=(
                dev if name == "cuda" else "cpu")).run_task(
                "transcription", wav, TINY_CONFIG)
            log(f"tiny pretrained-path transcription on {name}: "
                f"{time.perf_counter() - t:.3f} s, {len(rows[name])} rows")
        strip = lambda rs: [{**r, "payload": {k: v for k, v in r["payload"].items()  # noqa: E731
                                              if k != "confidence"}} for r in rs]
        conf = [(a["payload"]["confidence"], b["payload"]["confidence"])
                for a, b in zip(rows["cuda"], rows["cpu"])]
        equal = strip(rows["cuda"]) == strip(rows["cpu"]) and \
            all(abs(a - b) <= 1e-4 for a, b in conf)
        margin = 0.0
        if not rows["cpu"]:
            raise AssertionError("the pretrained path emitted no rows on the CPU")
        if equal:
            log("tiny pretrained-path rows: card equals CPU")
        else:
            margin = _first_divergence_margin(cpu_model, card_model, wav, dev)
            if not margin < TOKEN_MARGIN_TOL:
                raise AssertionError(f"card rows differ from the CPU's and the CPU's "
                                     f"top-2 margin is {margin} >= {TOKEN_MARGIN_TOL}")
        t = time.perf_counter()
        ladder = InferenceEngine(model_cache_dir=cache, device=dev).run_task(
            "transcription", wav, {k: v for k, v in TINY_CONFIG.items()
                                   if k != "temperatures"})
        if not all(math.isfinite(r["payload"]["confidence"]) for r in ladder):
            raise AssertionError("the temperature ladder gave non-finite rows")
        log(f"tiny with the temperature ladder on the card: "
            f"{time.perf_counter() - t:.3f} s, {len(ladder)} rows")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        transcribe._load_model.cache_clear()
    return {"enc_max_abs_err": enc_err, "rows_equal": equal,
            "rows": len(rows["cpu"]), "margin": margin}


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
    k3 = phase_k3(dev)
    phase_logits_reference(dev)
    with tempfile.TemporaryDirectory(prefix="eioku_smoke_") as workdir:
        sl = phase_slice(dev, workdir)
        wav = os.path.join(workdir, "speech.wav")
        write_speech_wav(wav)
        tr = phase_transcription(dev, wav)
        dec = phase_production_decode(dev, wav)
        vs_cpu = phase_card_vs_cpu(dev, wav, workdir)
    kernels = [
        {"name": "scene_diff", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/scene_diff.cu",
         "replaces": "eioku_tpu/ops/scene_diff.py:32",
         "launches": sl["launches"]["scene_diff"], **k1},
        {"name": "nms_keep", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/nms.cu",
         "replaces": "eioku_tpu/ops/nms.py:30",
         "launches": sl["launches"]["nms"], **k2},
        {"name": "flash_attention", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/flash_attention.cu",
         "replaces": "eioku_tpu/ops/flash_attention.py:27",
         "launches": tr["launches"]["flash_attention"], **k3},
    ]
    print(json.dumps({"slice": {k: v for k, v in sl.items() if k != "launches"}}))
    print(json.dumps({"transcription": {k: v for k, v in tr.items() if k != "launches"},
                      "production_decode": dec, "card_vs_cpu": vs_cpu}))
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
