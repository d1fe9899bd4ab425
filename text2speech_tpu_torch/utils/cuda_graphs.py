"""CUDA-graph capture and replay of the port's launch-bound loops.

The decoder's steps and the encoder's BiLSTM launch thousands of small
kernels a call from Python, one at a time; on the card the host's launches,
not the kernels, set their pace.  A CUDA graph captured once replays the
same kernels in the same order from one launch, so what it computes equals
the eager loop's result bit for bit.

A :class:`GraphCache` keeps a few captured calls (:class:`Graph`), each
under :func:`graph_key`: what the caller can observe that changes the
captured work beyond the inputs' values.  A graph reads the parameters at
the addresses they had when it was captured: a copy into them in place
(``load_state_dict``) is seen by the next replay, and a parameter that
moved (``.to()``, ``assign=True``) gives another key.  :func:`usable` says
where graphs engage; everywhere else the caller runs its eager loop."""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from .profiling import count

# eager runs of a captured function on a side stream before its capture
# (the lazy set-up of cuBLAS and cuDNN happens outside the graph)
WARMUP = 2
# captured calls a cache keeps; the least recently used goes first
CACHE_SIZE = 8


def dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its memory without gaps or overlaps,
    its dimensions in any order (a contiguous tensor, or a transpose of
    one)."""
    size = 1
    for stride, n in sorted((s, n) for s, n in zip(t.stride(), t.shape)
                            if n != 1):
        if stride != size:
            return False
        size *= n
    return True


def usable(*tensors: torch.Tensor) -> bool:
    """Whether a call over ``tensors`` may replay a graph: autograd off,
    every tensor on a CUDA device and :func:`dense` (so its static input
    takes its very layout, and the graph computes what the eager loop
    would), no capture in progress on the current stream, and no autocast
    with its cast cache on (a cached cast would outlive the capture)."""
    if torch.is_grad_enabled():
        return False
    if not all(t.is_cuda and dense(t) for t in tensors):
        return False
    if torch.cuda.is_current_stream_capturing():
        return False
    return not (torch.is_autocast_enabled("cuda")
                and torch.is_autocast_cache_enabled())


def graph_key(module: torch.nn.Module, tensors) -> tuple:
    """What a graph of ``module``'s work over ``tensors`` depends on
    beyond their values: the device, the inputs' number, shapes, strides
    and dtypes (an absent optional input makes the list shorter), autocast
    and its type, both TF32 flags (a captured product keeps the algorithm
    it was captured with), inference mode (its static buffers can be
    written only inside it) and the addresses of the module's
    parameters."""
    dev = tensors[0].device
    return (dev,
            tuple((tuple(t.shape), t.stride(), t.dtype) for t in tensors),
            torch.is_autocast_enabled(dev.type),
            torch.get_autocast_dtype(dev.type),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.is_inference_mode_enabled(),
            tuple(p.data_ptr() for p in module.parameters()))


class Graph:
    """One captured call of ``fn(*inputs)``: ``inputs``, its static
    inputs (copies of the tensors it was captured on, in their layouts),
    the graph, and ``outputs``, what ``fn`` returned during the capture.
    A replay overwrites ``outputs`` and may overwrite ``inputs``, so a
    caller holds ``lock`` from its first copy in to its last copy out."""

    def __init__(self, fn, inputs):
        self.inputs = [torch.empty_strided(t.shape, t.stride(),
                                           dtype=t.dtype,
                                           device=t.device).copy_(t)
                       for t in inputs]
        self.lock = threading.Lock()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # other threads may use the card while this one captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs)

    def replay(self, *inputs):
        """Copy ``inputs`` into the first ``len(inputs)`` static inputs
        (the rest keep what they hold), replay, and return ``outputs``."""
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        return self.outputs


class GraphCache:
    """At most :data:`CACHE_SIZE` captured calls by key.  Each capture adds
    1 to the counter ``counter`` (``utils/profiling.count``).  A copy of
    the cache (a deep copy or a pickle of its module) starts empty."""

    def __init__(self, counter: str):
        self.counter = counter
        self._graphs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, fn, inputs) -> Graph:
        """The graph under ``key``, captured from ``fn(*inputs)`` if there
        is none."""
        with self._lock:
            graph = self._graphs.pop(key, None)
            if graph is None:
                graph = Graph(fn, inputs)
                count(self.counter, 1)
            self._graphs[key] = graph
            while len(self._graphs) > CACHE_SIZE:
                self._graphs.popitem(last=False)
            return graph

    def __len__(self) -> int:
        return len(self._graphs)

    def __reduce__(self):
        return GraphCache, (self.counter,)
