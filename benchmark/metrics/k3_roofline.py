"""K3 (`csrc/flash_attention.cu`, `flash_hopper`) in the profiler's slice:
the least time its calls could take (their operations, 4 B H S^2 D, at the
bf16 peak, or their bytes at the bandwidth, whichever is larger) over their
device time, in percent. Each call of the slice is one encoder layer of one
batch of windows."""
from benchmark import roofline


def read(r):
    prof = r["profile"]
    if prof is None:
        return None
    names = [n for n in prof["kernels"] if "flash_hopper" in n]
    seconds = sum(prof["kernels"][n] for n in names)
    calls = sum(prof["calls"][n] for n in names)
    if not calls or seconds <= 0:
        return None
    dims = r["dims"]
    heads = dims["encoder_attention_heads"]
    bound = roofline.flash_attention_bound_s(r["batch"], heads, dims["max_source_positions"],
                                             dims["d_model"] // heads)
    return calls * bound / seconds * 100
