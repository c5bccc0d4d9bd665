"""The whole query: MiniLM's operations over each answered query's real
tokens, plus the IVF probe's scores (the centroids and the expected rows of
the probed clusters), over the window's wall time at the bf16 peak, in
percent."""
from benchmark import roofline


def read(r):
    server = r["server"]
    clusters, queries = server.get("clusters"), server.get("ivf_queries", 0)
    if not clusters or not queries or not r["tokens"]:
        return None
    probed = server["probed_rows"] / queries
    flops = sum(roofline.minilm_flops(n) + roofline.ivf_probe_flops(clusters, probed)
                for n in r["tokens"])
    return flops / (r["window_s"] * roofline.PEAK_FLOPS["bfloat16"]) * 100
