"""The median duration of the semantic index's search (`index/semantic.py`
`SemanticIndex.search`: the query's embedding, retrieval and the SQLite
join per hit): a synchronised span in the server, over
the window's calls, in ms."""
from benchmark import harness


def read(r):
    return harness.span_median_ms(r["server"].get("spans", {}).get("index_search"))
