"""The benchmark's launcher of the port's API server: installs the
benchmark's wrappers in the server process, then runs the port's own
`eioku_tpu_torch.api.main.main()`.

    python -m benchmark.drivers.server --out FILE [--trace] [--fault NAME] -- <main's arguments>

Always: each query's embedding is kept (the check compares it). With
--trace: synchronised spans of `SemanticIndex.search`, `embed_texts` and
`IvfIndex.search`, and a profiler slice between two SIGUSR2 signals.
SIGUSR1 marks the window's start (the peak memory counter is reset there).
SIGINT ends the server; the launcher then writes FILE (JSON) and exits.
--fault plants one of the check's faults on the timed path (tests only).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402

FAULTS = ("stale_state", "half_batch", "altered_answer")


class Launcher:
    def __init__(self, trace: bool, fault: str | None):
        import torch

        from eioku_tpu_torch.index import ivf, semantic

        self.torch = torch
        self.cuda = torch.cuda.is_available() and os.environ.get("EIOKU_FORCE_CPU") != "1"
        self.spans = harness.Spans(sync=trace and self.cuda)
        self.trace = trace
        self.embeddings: dict[str, list[float]] = {}
        self.searches: list[tuple[str, float, float]] = []
        self.flags = {"reset_peak": False, "toggle": False}
        self.prof = None
        self.profile = None
        self.slice_t0 = 0.0
        self.probed_rows = 0.0
        self.queries = 0
        launcher = self
        embed_fn = semantic.SemanticIndex.embed_texts
        search_fn = semantic.SemanticIndex.search
        prev = {"q": None}

        def embed_texts(index, texts):
            out = embed_fn(index, texts)
            if len(texts) == 1:
                if fault == "stale_state" and prev["q"] is not None:
                    out = prev["q"].copy()
                prev["q"] = out.copy()
                launcher.embeddings[texts[0]] = out[0].tolist()
            return out

        def search(index, query, top_k=10, asset_id=None):
            launcher._at_entry()
            t0 = time.time()
            out = search_fn(index, query, top_k=top_k, asset_id=asset_id)
            if fault == "half_batch":
                out = out[:len(out) // 2]
            elif fault == "altered_answer" and out:
                out[0] = dict(out[0], score=-out[0]["score"])
            if launcher.trace:
                launcher.searches.append((query, t0, time.time()))
            launcher._at_exit()
            return out
        self.spans.patch(semantic.SemanticIndex, "embed_texts", embed_texts)
        self.spans.patch(semantic.SemanticIndex, "search", search)
        if trace:
            self.spans.wrap(semantic.SemanticIndex, "search", "index_search")
            self.spans.wrap(semantic.SemanticIndex, "embed_texts", "query_embed")

            def probe_meta(args, kwargs, out):
                index = args[0]
                n_probe = max(index.k // 8, 1)
                launcher.probed_rows += index.n_vectors * n_probe / index.k
                launcher.queries += 1
                return {"clusters": index.k}
            self.spans.wrap(ivf.IvfIndex, "search", "retrieval", meta=probe_meta)

    def _at_entry(self) -> None:
        torch = self.torch
        if self.flags["reset_peak"]:
            self.flags["reset_peak"] = False
            self.spans.records.clear()
            self.searches.clear()
            self.probed_rows, self.queries = 0.0, 0
            if self.cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
        if self.flags["toggle"] and self.prof is None and self.profile is None and self.cuda:
            from torch.profiler import ProfilerActivity, profile

            self.flags["toggle"] = False
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.slice_t0 = time.perf_counter()

    def _at_exit(self) -> None:
        if self.flags["toggle"] and self.prof is not None:
            self.flags["toggle"] = False
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - self.slice_t0
            self.prof.stop()
            self.profile = (self.prof, wall)
            self.prof = None

    def report(self, path: str) -> None:
        torch = self.torch
        out = {"embeddings": self.embeddings, "cuda": self.cuda,
               "forbidden": harness.forbidden_modules()}
        if self.cuda:
            out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
            out["kind"] = torch.cuda.get_device_name(0)
        if self.trace:
            out["spans"] = {k: [(a, b) for a, b, _ in v] for k, v in self.spans.records.items()}
            out["searches"] = self.searches
            out["probed_rows"] = self.probed_rows
            out["ivf_queries"] = self.queries
            clusters = [m["clusters"] for _, _, m in self.spans.records.get("retrieval", [])]
            out["clusters"] = clusters[-1] if clusters else None
            if self.profile is not None:
                prof, wall = self.profile
                out["profile"] = harness.profile_summary(prof, wall)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, path)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--trace", action="store_true")
    parser.add_argument("--fault", choices=FAULTS)
    args, rest = parser.parse_known_args()
    if rest and rest[0] == "--":
        rest = rest[1:]
    launcher = Launcher(args.trace, args.fault)
    signal.signal(signal.SIGUSR1, lambda *_: launcher.flags.__setitem__("reset_peak", True))
    signal.signal(signal.SIGUSR2, lambda *_: launcher.flags.__setitem__("toggle", True))
    from eioku_tpu_torch.api import main as api_main

    sys.argv = ["eioku_tpu_torch.api.main"] + rest
    try:
        api_main.main()
    except KeyboardInterrupt:
        pass
    finally:
        launcher.spans.restore()
        launcher.report(args.out)


if __name__ == "__main__":
    main()
