"""Device: the share of the profiler's slice (one whole-recording chapters
job's prefill and its first decode steps) in which no kernel ran, in
percent. The busy time is the union of the kernels' intervals without the
profiler's device-side mirrors of host ranges (`drivers/kimi_linear.py`
`_kernel_busy_s`): the program's `llm.kda` and `llm.mla` ranges would
otherwise cover the gaps between their kernels."""


def read(r):
    prof, busy = r["profile"], r.get("kernel_busy_s")
    if prof is None or busy is None or prof["window_s"] <= 0:
        return None
    return (1 - busy / prof["window_s"]) * 100
