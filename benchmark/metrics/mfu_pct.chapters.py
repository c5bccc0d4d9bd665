"""The whole chapters step: the useful operations of the traced window from
shapes (each real prompt token and each decode row through the published
math, `drivers/chapters.py` `token_flops` and `prefill_flops`) over the
window's wall time at the bf16 peak, in percent."""
from benchmark import roofline


def read(r):
    flops = r["counters"].get("useful_flops", 0)
    if not flops or r["window_s"] <= 0:
        return None
    return flops / (r["window_s"] * roofline.PEAK_FLOPS["bfloat16"]) * 100
