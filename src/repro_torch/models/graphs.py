"""CUDA graphs of a service's segments (``models.segmentation``): the
port's counterpart of the JAX package running each segment as one
``jax.jit`` program.

A segment's body (state -> state, each a tensor or a tuple of tensors)
called on a CUDA input is captured once per input signature (the leaves'
shapes, dtypes and device) into a ``torch.cuda.CUDAGraph`` and replayed on
every later call; an input on any other device runs the body as it is. A
graph bakes in the pointers of the weights it reads, so each segment
instance (each layer's) has graphs of its own. The first call with a
signature

1. runs the body eagerly on the service's capture stream, which builds the
   kernels and the library handles (cuBLAS's workspace for that stream)
   outside any capture;
2. copies its input into static buffers allocated outside the graph's pool
   (one set a signature, shared by the service's graphs) and captures the
   body over them on the calling thread, with
   ``capture_error_mode="thread_local"`` (onboarding, the measurement
   engine and the serving engine call segments from three threads);
3. returns through the replay path, as every later call does: copy the
   input into the static buffers, replay, clone the outputs out of the
   pool.

The clone is required: one service's graphs share one memory pool, and
its requests interleave segment by segment, so a static output returned
as it is would be overwritten by the next replay. An output leaf that is
an input leaf (the encoder output a decoder layer passes on) is returned
as the caller's own. Sharing the pool and the static inputs is safe
because a service's calls issue one at a time (``SegmentGraphs.lock``) on
the caller's stream, each replay's input is copied in just before it and
its outputs are copied out before the next replay is issued, and the
static outputs stay alive, so no later capture reuses their memory.

The kernels' launch counters (``kernels._launches``) do not move on a
replay: a capture's own counts are kept aside as its graph's delta and
booked on each later call, so the counters read as on the eager path.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, NamedTuple

import torch

from repro_torch import spans
from repro_torch.kernels import _launches


class Captured(NamedTuple):
    """One captured body."""
    graph: object                  # ``replay()``s the captured kernels
    static_in: tuple               # the buffers the graph reads its input from
    static_out: object             # the tensor or tuple the capture returned
    launches: collections.Counter  # the capture's kernel launches


def _leaves(state) -> tuple:
    return state if isinstance(state, tuple) else (state,)


def replay(cap: Captured, state):
    """Copy ``state`` in, replay, and return the outputs copied out of the
    pool (an output that is an input buffer as the caller's own input)."""
    leaves = _leaves(state)
    for buf, x in zip(cap.static_in, leaves):
        buf.copy_(x)
    cap.graph.replay()

    def out(t):
        for buf, x in zip(cap.static_in, leaves):
            if t is buf:
                return x
        return t.clone()
    o = cap.static_out
    return tuple(map(out, o)) if isinstance(o, tuple) else out(o)


class SegmentGraphs:
    """The graphs of one service's segments, whose tensors live on one
    device: their shared memory pool, capture stream and static inputs (one
    set a signature), made on the first capture that needs them, and the
    lock under which the service's calls issue."""

    def __init__(self):
        self.lock = threading.Lock()
        self._pool = None
        self._stream = None
        self._inputs: Dict[tuple, tuple] = {}

    def capture(self, body: Callable, state, sig: tuple) -> Captured:
        """Run ``body`` on ``state`` eagerly, then capture it over the static
        inputs of ``state``'s signature ``sig`` (the caller holds
        ``lock``)."""
        leaves = _leaves(state)
        dev = leaves[0].device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        if sig not in self._inputs:
            self._inputs[sig] = tuple(torch.empty_like(x) for x in leaves)
        static_in = self._inputs[sig]
        for buf, x in zip(static_in, leaves):
            buf.copy_(x)
        static = static_in if isinstance(state, tuple) else static_in[0]
        graph = torch.cuda.CUDAGraph()
        caller = torch.cuda.current_stream(dev)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            body(static)
            with _launches.recording() as launches:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    static_out = body(static)
                finally:
                    graph.capture_end()
        caller.wait_stream(self._stream)
        spans.count_graph("captured")
        return Captured(graph, static_in, static_out, launches)


class Graphed:
    """``body`` replayed from a graph per input signature on a CUDA input,
    run as it is on any other."""

    def __init__(self, body: Callable, graphs: SegmentGraphs):
        self.body = body
        self.graphs = graphs
        self.captured: Dict[tuple, Captured] = {}

    @staticmethod
    def _on_device(x) -> bool:
        return x.device.type == "cuda"

    def __call__(self, state):
        leaves = _leaves(state)
        if not self._on_device(leaves[0]):
            return self.body(state)
        sig = tuple((x.shape, x.dtype, x.device) for x in leaves)
        with self.graphs.lock:
            cap = self.captured.get(sig)
            if cap is None:
                cap = self.captured[sig] = self.graphs.capture(
                    self.body, state, sig)
                spans.count_graph("eager")
            else:
                _launches.add(cap.launches)
                spans.count_graph("replayed")
            return replay(cap, state)
