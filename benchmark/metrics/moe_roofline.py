"""The routed experts' GEMMs (`models/llm/model.py` `routed_experts`: two
grouped GEMMs a call, `torch._grouped_mm`) in the profiler's slice (one
job's prefill and its first decode steps): the least time of their calls
over their device time, in percent. A call's least time is the larger of
its operations (2 x 3 x 2048 x 1408 per token-expert pair) at the bf16 peak
and its bytes (the experts hit, each read once, and the tokens in and out)
at the bandwidth (`drivers/chapters.py` `expert_bound_s`, summed by the
traced run's wrapper from each call's group ends). The device time is that
of the kernels whose names hold one of `NAMES`: the grouped GEMM kernels
that `torch._grouped_mm` launches on the card."""

NAMES = ("GroupProblemShape", "grouped", "Grouped")


def read(r):
    prof = r["profile"]
    if prof is None or not r.get("moe_calls"):
        return None
    seconds = sum(s for n, s in prof["kernels"].items() if any(k in n for k in NAMES))
    if seconds <= 0:
        return None
    return r["moe_bound_s"] / seconds * 100
