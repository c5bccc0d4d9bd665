"""A decoder's step captured as a CUDA graph over static buffers: the one
holder of Whisper's and Moonlight's graphed decode steps.

`hand_out` lends a decode its model's graph of one shape. Each step the
model writes its inputs into `graph.buffers` and calls `replay`; the first
replay captures `body(model, buffers)` after one eager run on a side stream
(the allocator's blocks and the libraries' workspaces), whose writes are the
ones the replay repeats. Buffers that a step updates from their own values
(a recurrent state: Kimi-Linear's) are listed in `buffers.carried`; the
eager run's updates to them are undone, so that the first step advances
them once. Counters `{prefix}decode_graph_captures` and
`{prefix}decode_graph_replays`.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager

import torch

from eioku_tpu_torch.utils.metrics import METRICS

# Decode shapes a model keeps. Whisper's batched transcription makes one, its
# conditioned decode two (caches of 256 and 448 positions); Moonlight's
# chapters one a cache length (a multiple of 1,024 positions).
KEPT = 4
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> {key: CapturedStep}
_LOCK = threading.Lock()


class CapturedStep:
    """One decode shape: its static `buffers`, the graph of `body` over them
    once captured, the addresses of the model's parameters it was made over
    (`weights`), and whether a decode holds it (`in_use`)."""

    def __init__(self, buffers, body, weights: tuple, prefix: str):
        self.buffers = buffers
        self.body = body
        self.weights = weights
        self.prefix = prefix
        self.graph = None
        self.logits = None
        self.in_use = False

    def replay(self, model) -> torch.Tensor:
        """The step on the buffers: a copy of its logits."""
        if self.graph is None:
            self.graph = self._capture(model)
            METRICS.count(self.prefix + "decode_graph_captures")
        self.graph.replay()
        METRICS.count(self.prefix + "decode_graph_replays")
        return self.logits.clone()

    def _warm_up(self, model) -> None:
        """One eager run of the body, its updates to `buffers.carried`
        undone."""
        carried = getattr(self.buffers, "carried", ())
        before = [t.clone() for t in carried]
        self.body(model, self.buffers)
        for t, b in zip(carried, before):
            t.copy_(b)

    def _capture(self, model):
        with torch.cuda.device(next(model.parameters()).device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._warm_up(model)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.logits = self.body(model, self.buffers)
        return graph


@contextmanager
def hand_out(model, key, make_buffers, body, prefix: str):
    """Yields the model's CapturedStep of shape `key`, the caller's alone
    until the block ends, or None while another decode holds it. A shape is
    made (`make_buffers()`) at its first use and made anew where the model's
    parameters have moved; of more than KEPT, the least recently used idle
    one is dropped, a held one never."""
    weights = tuple(p.data_ptr() for p in model.parameters())
    with _LOCK:
        graphs = _GRAPHS.setdefault(model, OrderedDict())
        graph = graphs.pop(key, None)
        if graph is not None and graph.in_use:
            graphs[key] = graph
            graph = None
        else:
            if graph is None or graph.weights != weights:
                idle = [k for k, g in graphs.items() if not g.in_use]
                for old in idle[:max(len(graphs) + 1 - KEPT, 0)]:
                    del graphs[old]
                graph = CapturedStep(make_buffers(), body, weights, prefix)
            graph.in_use = True
            graphs[key] = graph
    try:
        yield graph
    finally:
        if graph is not None:
            graph.in_use = False


def holding(model, match) -> CapturedStep | None:
    """The model's CapturedStep whose buffers `match` accepts, if any."""
    with _LOCK:
        return next((g for g in _GRAPHS.get(model, {}).values() if match(g.buffers)), None)
