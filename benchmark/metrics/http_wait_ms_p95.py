"""HTTP API (`web/server.py`, `api/controllers.py`): a request's latency, from
when it was due, less the server's `SemanticIndex.search` call for it
(queueing on the one event loop, HTTP, JSON); the 95th percentile over the
window's answered requests that were matched to their call (same query,
the call inside the request's send and answer)."""
import bisect
import math


def read(r):
    searches = sorted((t0, t1, q) for q, t0, t1 in r["server"].get("searches", ()))
    starts = [s[0] for s in searches]
    waits = []
    for req in r["requests"]:
        if req.get("status") != 200 or "sent_wall" not in req:
            continue
        i = bisect.bisect_left(starts, req["sent_wall"] - 1e-3)
        while i < len(searches) and searches[i][0] <= req["done_wall"]:
            t0, t1, q = searches[i]
            if q == req["q"]:
                waits.append(req["latency"] - (t1 - t0))
                break
            i += 1
    if not waits:
        return None
    waits.sort()
    return waits[max(math.ceil(0.95 * len(waits)), 1) - 1] * 1e3
