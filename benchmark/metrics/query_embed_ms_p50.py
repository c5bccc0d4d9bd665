"""The median duration of MiniLM's query embedding (`models/embed/minilm.py` through
`SemanticIndex.embed_texts`: tokenizing, one [32, 256] padded batch, the
copy back): a synchronised span in the server, over
the window's calls, in ms."""
from benchmark import harness


def read(r):
    return harness.span_median_ms(r["server"].get("spans", {}).get("query_embed"))
