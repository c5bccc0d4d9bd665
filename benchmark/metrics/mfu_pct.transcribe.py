"""The whole transcription step: the useful operations of the traced window
from shapes (the encoder on real windows, their cross-attention keys and
values, each decoder step on the real windows' beam rows) over the window's
wall time at the bf16 peak, in percent."""
from benchmark import roofline


def read(r):
    flops = r["counters"].get("useful_flops", 0)
    if not flops or r["window_s"] <= 0:
        return None
    return flops / (r["window_s"] * roofline.PEAK_FLOPS["bfloat16"]) * 100
