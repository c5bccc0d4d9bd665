"""Where the int8 detector's peak memory comes from, beside bf16's.

    python3 tools/int8_peak_probe.py [--batch 64] [--group-bytes N ...]

Builds YOLOv8n (80 classes, random weights from a seed), folds its batch
norms and runs `detect` on one batch of random 640x640 uint8 frames on the
card, once in bf16 and with every conv quantized (`quantize_convs`) once
for each `--group-bytes` (ops/quant.py's ACC_GROUP_BYTES, the int32 sums a
quantized conv holds at once; the default is the module's value). For each
run it reports the peak of allocated memory above what was allocated
before the call, the mean time of one detect call (CUDA events), and the
convolutions whose own calls reached the highest peaks (each conv's call
is watched from its pre-hook to its hook: the peak above the call's
baseline, and the part of it that the inputs and the live tensors of
earlier layers already held). The cv1 of
the neck's quantized C2fs runs through `forward_parts`, which the hooks do
not see; it is counted in the whole run's peak. Prints one JSON line on
stdout and the card's name and power limit on the line after it. Needs
CUDA; exits nonzero without it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the card's name and power limit)

MIB = 2 ** 20


def watch_convs(model, kinds) -> tuple[list, list]:
    """Hooks on every module of `kinds`: [(name, baseline MiB, peak MiB)]."""
    import torch

    seen, handles = [], []
    for name, module in model.named_modules():
        if not isinstance(module, kinds):
            continue

        def pre(mod, args, name=name):
            torch.cuda.reset_peak_memory_stats()
            mod._probe_base = torch.cuda.memory_allocated()

        def post(mod, args, out, name=name):
            seen.append((name, mod._probe_base / MIB, torch.cuda.max_memory_allocated() / MIB))

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    return seen, handles


def run(model, frames, kinds) -> dict:
    import torch

    from eioku_tpu_torch.models.yolo.postprocess import detect

    detect(model, frames, conf_threshold=0.5)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    detect(model, frames, conf_threshold=0.5)
    torch.cuda.synchronize()
    whole = (torch.cuda.max_memory_allocated() - base) / MIB
    seen, handles = watch_convs(model, kinds)
    detect(model, frames, conf_threshold=0.5)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    top = sorted(seen, key=lambda s: -s[2])[:6]
    ms = chip_smoke.cuda_ms(lambda: detect(model, frames, conf_threshold=0.5),
                            iters=5, warmup=1)
    return {"peak_above_call_mib": whole, "detect_ms": ms,
            "top_convs": [{"conv": n, "baseline_mib": b - base / MIB,
                           "peak_mib": p - base / MIB, "own_mib": p - b}
                          for n, b, p in top]}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--group-bytes", type=int, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_peak_probe: needs CUDA", file=sys.stderr)
        return 2
    from eioku_tpu_torch.models.layers import QuantConv2d, quantize_convs
    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
    from eioku_tpu_torch.ops import quant

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (args.batch, 640, 640, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    out = {"batch": args.batch}
    runs = [("bf16", None)] + [(f"int8 groups {g}", g) for g in
                               args.group_bytes or [quant.ACC_GROUP_BYTES]]
    for label, group_bytes in runs:
        model = fold_batchnorm(YOLOv8(YoloConfig("yolov8n"),
                                      generator=torch.Generator().manual_seed(0)))
        if group_bytes is not None:
            quant.ACC_GROUP_BYTES = group_bytes
            quantize_convs(model)
        model = model.to(device=dev, dtype=torch.bfloat16).eval()
        with torch.no_grad():
            out[label] = run(model, frames, (torch.nn.Conv2d, QuantConv2d))
        print(f"{label}: peak {out[label]['peak_above_call_mib']:.1f} MiB above the "
              f"call's baseline, {out[label]['detect_ms']:.2f} ms a call; top convs "
              f"{out[label]['top_convs'][:3]}", file=sys.stderr)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
