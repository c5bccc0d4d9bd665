"""Device: the share of the profiler's slice (one chapters job's prefill and
its first decode steps) in which no kernel ran, in percent."""


def read(r):
    prof = r["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return (1 - prof["busy_s"] / prof["window_s"]) * 100
