"""Tracing and profiling helpers (counterpart of
``text2speech_tpu/utils/profiling.py``): the program's spans and counters,
a trace of a block written as a Chrome trace (it opens in Perfetto, as the
JAX package's trace does), and a step timer that tells host time from
device time.

The port marks its layer boundaries with :func:`annotate` (a span) and
:func:`count` (a counter).  Both cost one global check when nothing
listens.  Under :func:`recording` they are kept in memory on
``time.perf_counter``, the clock a benchmark's own spans and its device
trace are placed on; under a ``torch.profiler`` (:func:`trace_capture`) a
span is also a ``record_function`` region, so the Chrome trace names the
same layers::

    with recording() as rec:
        synth.synthesize(texts)
    rec.spans      # [(name, start, end, parent id, id)], in closing order
    rec.counters   # {name: [(time, value)]}

Span names are dotted by layer (``taco.decoder``, ``wg.flows``,
``train.allreduce``, ``serve.vocode``, ...) and fixed strings."""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# what annotate returns when nothing listens: one shared object, reentrant
_NULL = contextlib.nullcontext()
# the installed Recorder, or None
_RECORDER = None


def _profiler_active() -> bool:
    """Whether a ``torch.profiler`` is recording (a module flag the
    profiler sets; where a torch version lacks it, assume so)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", True)


class Recorder:
    """Spans and counters of one :func:`recording` block.  ``spans``:
    ``(name, start, end, parent, id)`` tuples, appended as each span
    closes; ``parent`` is the ``id`` of the innermost span open on the
    same thread when this one began (None at the top).  ``counters``:
    ``name -> [(time, value)]``.  Times are ``time.perf_counter`` seconds."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "start", "region")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.region = None
        if _profiler_active():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.region is not None:
            self.region.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.spans.append((self.name, self.start, end, self.parent,
                               self.id))
        return False


def annotate(name: str):
    """The span ``name`` around a ``with`` block: recorded when a
    :func:`recording` is open, a ``record_function`` region when a
    ``torch.profiler`` is active, and otherwise the shared null context
    (no allocation, no clock read, no profiler call)."""
    rec = _RECORDER
    if rec is not None:
        return _Span(rec, name)
    if _profiler_active():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, value) -> None:
    """Add ``(now, value)`` to counter ``name`` of the open recording;
    nothing without one."""
    rec = _RECORDER
    if rec is not None:
        rec.counters.setdefault(name, []).append((time.perf_counter(), value))


@contextlib.contextmanager
def recording():
    """Install a fresh :class:`Recorder` for the process and yield it; the
    one installed before (if any) is back in place when the block ends.
    Nothing is written out: read the recorder once the block has ended."""
    global _RECORDER
    prev, rec = _RECORDER, Recorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = prev


@contextlib.contextmanager
def trace_capture(logdir: str):
    """Record the enclosed block's CPU activity and, where a card is
    visible, its CUDA activity, and write it as a Chrome trace into
    ``logdir`` (one new file a capture, whose path the block is given; it
    exists once the block has ended)::

        with trace_capture(run_dir + "/profile") as path:
            for _ in range(10): train_step(...)
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
    path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def _sync_devices(out) -> None:
    """Wait for the CUDA device of every tensor in ``out`` (nested lists,
    tuples and dicts); CPU tensors need no wait."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall and device step timing::

        with timer.step() as t:
            out = step_fn(...)
            t.block_on(out)          # register what to wait for
        timer.last_host, timer.last_device

    ``last_host`` is the wall time from entering the block to its end;
    ``last_device`` also waits for the devices of what the block
    registered through ``t.block_on`` (the step's OUTPUT, which does not
    exist before the block runs)."""

    def __init__(self):
        self.last_host = 0.0
        self.last_device = 0.0

    class _Handle:
        def __init__(self):
            self.out = None

        def block_on(self, out):
            self.out = out

    @contextlib.contextmanager
    def step(self):
        h = self._Handle()
        t0 = time.perf_counter()
        yield h
        self.last_host = time.perf_counter() - t0
        if h.out is not None:
            _sync_devices(h.out)
            self.last_device = time.perf_counter() - t0
