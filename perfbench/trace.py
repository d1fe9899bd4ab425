"""Spans, counters and the device trace of one run, and what the per-layer
readers take from them.

Spans are the benchmark's own (host clock, ``time.perf_counter``) around
its calls into the program.  The device trace is ``torch.profiler``'s
CUDA activity over a bounded slice, exported as a Chrome trace under
``TMPDIR``, read and deleted.  Its clock is tied to the host's by a marker
launched right after a synchronise: the first device operation of the
slice.  Device busy time is the length of the union of the operations'
intervals (``profile_torch.py``'s ``busy_us``, copied)."""

from __future__ import annotations

import json
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Observation:
    """What a run gives the per-layer readers.  ``ops``: device operations
    of the traced slice as (name, start us, duration us) on the host clock;
    ``slice_s``: (start, end) of the slice on the host clock; ``info``:
    the traffic's own facts (shapes, counts) keyed by name."""

    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    ops: list = field(default_factory=list)
    slice_s: tuple | None = None
    info: dict = field(default_factory=dict)
    pending: tuple | None = None

    @contextmanager
    def span(self, name: str, sync=None):
        """Record ``name`` around the block; ``sync`` (a callable) runs
        before the end is read, so the span covers the device's work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.spans.append((name, t0, time.perf_counter()))

    def count(self, name: str, value) -> None:
        """Record ``value`` of counter ``name`` now (host clock)."""
        self.counters.setdefault(name, []).append(
            (time.perf_counter(), value))

    def spans_named(self, name: str) -> list:
        return [(a, b) for n, a, b in self.spans if n == name]

    def ops_named(self, *needles: str) -> list:
        return [o for o in self.ops if any(n in o[0] for n in needles)]


def union_us(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    busy, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        if ts + dur > end:
            busy += ts + dur - max(ts, end)
            end = ts + dur
    return busy


def busy_s(obs: Observation) -> float:
    return union_us((ts, dur) for _, ts, dur in obs.ops) / 1e6


def window_s(obs: Observation) -> float:
    lo, hi = obs.slice_s
    return hi - lo


@contextmanager
def device_trace(obs: Observation, torch):
    """Trace the device over the block.  The trace is read later, by
    :func:`finish` (the harness calls it once the window has closed), so
    that exporting it delays nothing inside the window."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros((1,), device="cuda")
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        t_marker = time.perf_counter()
        marker.add_(1.0)
        yield
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        prof.__exit__(None, None, None)
    obs.pending = (prof, t_marker, t_end)


def finish(obs: Observation) -> None:
    """Read a pending trace into ``obs.ops`` (host-clock microseconds:
    the first operation, the marker, fixes the offset) and
    ``obs.slice_s`` (host-clock seconds)."""
    if obs.pending is None:
        return
    prof, t_marker, t_end = obs.pending
    obs.pending = None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops = sorted((e["ts"], e["dur"], e["name"]) for e in events
                 if e.get("cat") in DEVICE_OP_CATS and e.get("ph") == "X")
    if not ops:
        raise RuntimeError("the device trace holds no operation: the "
                           "profiler saw no CUDA activity")
    offset = ops[0][0] - t_marker * 1e6
    obs.slice_s = (t_marker, t_end)
    obs.ops = [(name, ts - offset, dur) for ts, dur, name in ops[1:]
               if ts - offset < t_end * 1e6]


def breakdown(obs: Observation, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost benchmark span around each."""
    by_name: dict = {}
    for name, _, dur in obs.ops:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    end = obs.slice_s[0] * 1e6
    for _, ts, dur in sorted(obs.ops, key=lambda o: o[1]):
        if ts > end:
            gaps.append((end, ts))
        end = max(end, ts + dur)
    if obs.slice_s[1] * 1e6 > end:
        gaps.append((end, obs.slice_s[1] * 1e6))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2e6
        inner = [(n, s, e) for n, s, e in obs.spans if s <= mid <= e]
        name = (min(inner, key=lambda x: x[2] - x[1])[0] if inner
                else "outside the benchmark's spans")
        named.append([name, (b - a) / 1e6])
    return {"device_ops": [[n[:160], s] for n, s in device_ops],
            "idle_gaps": named}
