"""The whole whole-recording chapters job: the useful operations of the
traced window from shapes (each prompt token and each decode step through
the published math, MLA's causal attention and KDA's chunked products,
`drivers/kimi_linear.py` `token_flops`, `prefill_flops` and
`kda_chunk_flops`) over the window's wall time at the bf16 peak, in
percent."""
from benchmark import roofline


def read(r):
    flops = r["counters"].get("useful_flops", 0)
    if not flops or r["window_s"] <= 0:
        return None
    return flops / (r["window_s"] * roofline.PEAK_FLOPS["bfloat16"]) * 100
