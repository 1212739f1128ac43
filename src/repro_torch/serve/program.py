"""A serving program: one function over static buffers, run eagerly on the
CPU and replayed as one CUDA graph on the card.

The reference compiles one XLA program per (family, bucket) and donates
the buffers it updates.  Here a :class:`Program` holds the function and
the dict of tensors it reads and writes (inputs, parameters, state);
callers fill those buffers in place and call the program.  On CUDA the
first call warms the function up on a side stream (against a scratch copy
of the buffers it updates, named in ``mutable``, so the state does not
advance twice) and captures it; every call replays the graph, which reads
the buffers where they lie and updates the state in place.  The result is
the graph's own output tensor(s), overwritten by the next call: copy it
out before then.  Programs of one owner may share a graph memory pool
(``pool``): their intermediates are dead between replays, which run one
at a time on one stream, and each output stays allocated (and so is not
handed to another capture) for the program's life.

Capture runs with the garbage collector off and
``capture_error_mode="thread_local"`` (as ``core/engine.py`` captures):
the micro-batcher's pump thread captures while the main thread may launch
work of its own.  cuDNN is held to deterministic algorithms while a graph
is captured (a transposed convolution's default algorithm may add
atomically), so a conv G's bytes repeat from replay to replay.
"""

from __future__ import annotations

import gc

import torch

from repro_torch.device import deterministic_convolutions
from repro_torch.models.common import tree_map


class Program:
    """``fn(static) -> output`` over the tensors of ``static`` (a nested
    dict), all on one device."""

    def __init__(self, fn, static: dict, device: torch.device, *,
                 mutable=(), pool=None):
        self.fn, self.static, self.device = fn, static, device
        self.mutable, self.pool = tuple(mutable), pool
        self.graph = None
        self.out = None

    def __call__(self):
        with torch.no_grad():
            if self.device.type != "cuda":
                return self.fn(self.static)
            if self.graph is None:
                self._capture()
            self.graph.replay()
            return self.out

    def _capture(self) -> None:
        with deterministic_convolutions():
            self._capture_graph()

    def _capture_graph(self) -> None:
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            # warm-up (cuBLAS / cuDNN handles and workspaces)
            scratch = {k: tree_map(lambda t: t.clone(), v)
                       if k in self.mutable else v
                       for k, v in self.static.items()}
            self.fn(scratch)
            del scratch
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = self.fn(self.static)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = graph
