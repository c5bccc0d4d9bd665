"""Where K3's time goes: patched copies of csrc/flash_attention.cu, timed.

    python3 tools/k3_probe.py

Builds the bf16 kernel as it is and in copies with one part taken out or
changed, each with nvcc into eioku_tpu_torch/_build/k3_probe/ (all started
together), then times each copy at the Whisper large-v3 encoder's
[4, 20, 1500, 64] bf16 in its [B, S, H, D] layout (two input sets cycled
past the L2), in turns with F.scaled_dot_product_attention, and the real
kernel with lengths cutting the keys to 1..12 tiles of 128. A copy that
takes a part out computes wrong numbers: only its time means anything.

- base: the kernel as it is;
- no_exp: exp2 replaced by a multiply (the SFU's share);
- no_softmax: the softmax skipped (products and data movement only);
- no_pv, no_qk: one of the two products skipped;
- two_warpgroups: 128-row blocks, two consumers at 240 registers;
- two_stages: a 2-stage K/V ring.

Prints each copy's ptxas spill line and time on stderr, and one JSON line
on stdout. Needs CUDA; exits nonzero without it.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (timing helpers, the card's name)

PATCHES = {
    "base": [],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x * 0.5f;")],
    "no_softmax": [("  if (kMask) {\n#pragma unroll\n    for (int n = 0; n < 16; ++n) {",
                    "  if (true) {\n    alpha[0] = alpha[1] = 1.f;\n    return;\n  }\n"
                    "  if (kMask) {\n#pragma unroll\n    for (int n = 0; n < 16; ++n) {")],
    "no_pv": [("issue_pv<E, D>(o_acc, p, v_desc(", "if (0) issue_pv<E, D>(o_acc, p, v_desc(")],
    "no_qk": [("issue_qk<E, D>(s, q_desc, k_desc(", "if (0) issue_qk<E, D>(s, q_desc, k_desc(")],
    "two_warpgroups": [("constexpr int kWGs = 3;", "constexpr int kWGs = 2;"),
                       ("constexpr int kProducerRegs = 32;", "constexpr int kProducerRegs = 24;"),
                       ("constexpr int kConsumerRegs = 160;", "constexpr int kConsumerRegs = 240;")],
    "two_stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}


def build(out_dir: str) -> dict[str, str]:
    """One patched source and library per copy; returns ptxas' spill lines
    for the 16-bit kernels."""
    from eioku_tpu_torch.ops import _cuda

    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(_cuda.CSRC_DIR, "flash_attention.cu")).read()
    nvcc = _cuda._nvcc()
    stubs = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64", "stubs")
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
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
               os.path.join(out_dir, f"lib{name}.so"), path, f"-L{stubs}", "-lcuda"]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    spills = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills[name] = "; ".join(
            chip_smoke._spills(log, ("flash_hopper",))) or "none"
    return spills


def use(out_dir: str, name: str) -> None:
    """Route flash_attention's launches to the copy `name`."""
    from eioku_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
    _cuda._configure(lib)
    _cuda._libs["flash_attention"] = lib


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAILED: needs CUDA", file=sys.stderr)
        return 2
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.ops.flash_attention import flash_attention

    card = chip_smoke.nvidia_smi_line()
    out_dir = os.path.join(_cuda.BUILD_DIR, "k3_probe")
    spills = build(out_dir)
    dev = torch.device("cuda")
    b, h, s_len, d = chip_smoke.K3_SHAPE
    gen = torch.Generator(device=dev).manual_seed(7)
    sets = [tuple(torch.randn((b, s_len, h, d), generator=gen, device=dev)
                  .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
            for _ in range(2)]
    library = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, scale=d ** -0.5)
    times: dict[str, list[float]] = {name: [] for name in [*PATCHES, "sdpa"]}
    for _ in range(2):  # two rounds of turns
        for name in PATCHES:
            use(out_dir, name)
            times[name].append(chip_smoke.cuda_ms(flash_attention, iters=30, args=sets))
        times["sdpa"].append(chip_smoke.cuda_ms(library, iters=30, args=sets))
    use(out_dir, "base")
    by_tiles = {}
    for tiles in (1, 2, 3, 6, 9, 12):
        lens = torch.full((b,), min(tiles * 128, s_len), dtype=torch.int32, device=dev)
        by_tiles[tiles] = chip_smoke.cuda_graph_ms(
            lambda q, k, v: flash_attention(q, k, v, lengths=lens), args=sets)
    print(f"card: {card}", file=sys.stderr)
    for name, ts in times.items():
        print(f"  {name:15s} {' '.join(f'{t:.5f}' for t in ts)} ms"
              + (f"  (spills: {spills[name]})" if name in spills else ""), file=sys.stderr)
    for tiles, ms in by_tiles.items():
        print(f"  base, {tiles:2d} key tiles: {ms:.5f} ms (graph-replayed)", file=sys.stderr)
    print(json.dumps({"card": card, "shape": [b, h, s_len, d], "ms": times,
                      "spills": spills, "base_ms_by_key_tiles": by_tiles}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
