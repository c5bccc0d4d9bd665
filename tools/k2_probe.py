"""Where K2's time goes: patched copies of csrc/nms.cu, timed.

    python3 tools/k2_probe.py

Builds the NMS kernels as they are and in copies with one part taken out,
each with nvcc into eioku_tpu_torch/_build/k2_probe/ (all started
together), then times each copy replayed from a CUDA graph (device time,
no host) at B = 64 with K = 256 and 1024, on chip_smoke.py's candidates
(3 classes, a 20% zero-score tail), on the same boxes spread over 80
classes, and on the candidates YOLOv8n's detect() hands to the NMS (random
weights, random frames). A copy that takes a part out computes wrong keep masks: only its
time means anything.

- base: the kernels as they are;
- mask_only: the bitmask kernel alone (no scan launch);
- mask_no_iou, mask_no_loop: the bitmask kernel alone, walking its
  same-class columns without the IoU test, or not walking them at all;
- no_rounds: the scan keeps every alive box of a word, without the rounds
  that settle the greedy order inside it;
- no_or: the scan skips ORing kept rows into later words.
- or_by_kept: the scan ORs only the kept rows, found by find-first-set,
  instead of 64 predicated loads.

Then the wrapper's host cost: microseconds per call of nms_keep_mask and of
its parts (the bare ctypes launch, torch.empty, the current stream, a
no-op dtype conversion), on the host clock at K = 256.

Prints ptxas' report for the base copy, each copy's time on stderr, and one
JSON line on stdout. Needs CUDA; exits nonzero without it.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (workload, timing helpers, the card's name)

PATCHES = {
    "base": [],
    "mask_only": [("  nms_scan_kernel<<<", "  if (0) nms_scan_kernel<<<")],
    "mask_no_iou": [("  nms_scan_kernel<<<", "  if (0) nms_scan_kernel<<<"),
                    ("if (suppresses(inter, uni, iou_threshold, thr_lo, thr_hi)) bits |= 1u << v;",
                     "bits |= 1u << v;")],
    "mask_no_loop": [("  nms_scan_kernel<<<", "  if (0) nms_scan_kernel<<<"),
                     ("    while (same) {",
                      "    bits = same;\n    same = 0u;\n    while (same) {")],
    "no_rounds": [("    for (;;) {", "    for (; false;) {")],
    "no_or": [("      if (v > w && v <= last) {", "      if (false) {")],
    "or_by_kept": [("#pragma unroll\n        for (int t = 0; t < kTile; ++t)\n"
                    "          if ((kept >> t) & 1ull) acc |= col[t];",
                    "        for (unsigned m = static_cast<unsigned>(kept); m; m &= m - 1)\n"
                    "          acc |= col[__ffs(m) - 1];\n"
                    "        for (unsigned m = static_cast<unsigned>(kept >> 32); m; m &= m - 1)\n"
                    "          acc |= col[31 + __ffs(m)];")],
}
CASES = [(k, n_classes) for k in (256, 1024) for n_classes in (3, 80)]


def build(out_dir: str) -> str:
    """One patched source and library per copy; returns ptxas' report for
    the base copy."""
    from eioku_tpu_torch.ops import _cuda

    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(_cuda.CSRC_DIR, "nms.cu")).read()
    procs = {}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-fmad=false",
               "-o", os.path.join(out_dir, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    report = ""
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "base":
            report = "\n".join(line.strip() for line in log.splitlines()
                               if "Used" in line or "spill" in line or "Compiling" in line)
    return report


def use(out_dir: str, name: str) -> None:
    """Route nms's launches to the copy `name`."""
    from eioku_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
    _cuda._configure(lib)
    _cuda._libs["nms"] = lib


def yolo_candidates(dev, k: int):
    """The candidates detect() hands to the NMS: YOLOv8n at full width
    (random weights from seed 0, bf16) on 64 random 384 x 640 frames, top k
    of 80 classes."""
    import torch

    from eioku_tpu_torch.models.yolo import postprocess
    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm

    model = fold_batchnorm(YOLOv8(YoloConfig("yolov8n"),
                                  generator=torch.Generator().manual_seed(0))).eval()
    model = model.to(dev, torch.bfloat16)
    frames = torch.randint(0, 256, (chip_smoke.K2_BATCH, 384, 640, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    original = postprocess.nms_keep_mask
    try:
        calls = chip_smoke._capture_nms(postprocess)
        postprocess.detect(model, frames, top_k=k)
    finally:
        postprocess.nms_keep_mask = original
    return calls[0][:3]


def host_us(boxes, scores, classes, calls: int = 2000) -> dict[str, float]:
    """Host microseconds per call of the wrapper and of its parts, each
    timed over `calls` back-to-back calls on the host clock (the card runs
    behind; one synchronize at the end of each)."""
    import time

    import torch

    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.ops.nms import nms_keep_mask

    b, k = scores.shape
    words = -(-k // 64)
    keep = torch.empty((b, k), dtype=torch.uint8, device=boxes.device)
    scratch = torch.empty(b * words * (64 * words + 1), dtype=torch.int64,
                          device=boxes.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _cuda.load("nms")
    ptrs = (boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(), keep.data_ptr(),
            scratch.data_ptr(), b, k, 0.45, stream)
    parts = {
        "wrapper": lambda: nms_keep_mask(boxes, scores, classes, 0.45),
        "ctypes_launch": lambda: lib.eioku_nms_keep(*ptrs),
        "torch_empty": lambda: torch.empty((b, k), dtype=torch.uint8, device=boxes.device),
        "current_stream": lambda: torch.cuda.current_stream(boxes.device).cuda_stream,
        "to_contiguous": lambda: boxes.to(torch.float32).contiguous(),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: needs CUDA", file=sys.stderr)
        return 2
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.ops.nms import nms_keep_mask

    card = chip_smoke.nvidia_smi_line()
    out_dir = os.path.join(_cuda.BUILD_DIR, "k2_probe")
    report = build(out_dir)
    dev = torch.device("cuda")
    inputs = {}
    for k, n_classes in CASES:
        bx, sc, cl = chip_smoke._nms_workload(chip_smoke.K2_BATCH, k, seed=k,
                                              pad_from=k - k // 5, n_classes=n_classes)
        inputs[(k, n_classes)] = tuple(torch.from_numpy(a).to(dev) for a in (bx, sc, cl))
    for k in (chip_smoke.K2_MAIN_K, chip_smoke.K2_BIG_K):
        inputs[(k, "yolo")] = yolo_candidates(dev, k)
    times: dict[str, dict[str, list[float]]] = {name: {} for name in PATCHES}
    for _ in range(2):  # two rounds of turns
        for name in PATCHES:
            use(out_dir, name)
            for case, (boxes, scores, classes) in inputs.items():
                ms = chip_smoke.cuda_graph_ms(
                    lambda: nms_keep_mask(boxes, scores, classes, 0.45), args=((),))
                times[name].setdefault("K=%d, %s classes" % case, []).append(ms)
    host = host_us(*inputs[(chip_smoke.K2_MAIN_K, 3)])
    kept = {"K=%d, %s classes" % case: None for case in inputs}
    use(out_dir, "base")
    for case, (boxes, scores, classes) in inputs.items():
        kept["K=%d, %s classes" % case] = int(nms_keep_mask(boxes, scores, classes).sum())
    print(f"card: {card}\n{report}", file=sys.stderr)
    for name, by_case in times.items():
        for case, ts in by_case.items():
            print(f"  {name:10s} {case:20s} {' '.join(f'{t:.5f}' for t in ts)} ms "
                  f"(graph-replayed)", file=sys.stderr)
    print(f"  kept per case (B = {chip_smoke.K2_BATCH}): {kept}", file=sys.stderr)
    print("  host us per call at K=%d: %s" % (chip_smoke.K2_MAIN_K, ", ".join(
        f"{name} {us:.2f}" for name, us in host.items())), file=sys.stderr)
    print(json.dumps({"card": card, "batch": chip_smoke.K2_BATCH, "ms": times,
                      "kept": kept, "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
