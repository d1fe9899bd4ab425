"""Tracing and profiling helpers (counterpart of
``text2speech_tpu/utils/profiling.py``), over ``torch.profiler``: a trace
of the enclosed block written as a Chrome trace (it opens in Perfetto, as
the JAX package's trace does), named regions in that timeline, and a step
timer that tells host time from device time."""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


def annotate(name: str):
    """A named region in the profiler's timeline."""
    return torch.profiler.record_function(name)


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
