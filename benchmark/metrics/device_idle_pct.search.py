"""Device: the share of the server's profiler slice (a few seconds of
searches at the cell's rate, after the window) in which no kernel ran, in
percent."""


def read(r):
    prof = r["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return (1 - prof["busy_s"] / prof["window_s"]) * 100
