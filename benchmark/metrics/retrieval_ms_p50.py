"""The median duration of IVF retrieval (`index/ivf.py` `IvfIndex.search`:
the centroids, the probed blocks, top-k): a synchronised span in the server, over
the window's calls, in ms."""
from benchmark import harness


def read(r):
    return harness.span_median_ms(r["server"].get("spans", {}).get("retrieval"))
