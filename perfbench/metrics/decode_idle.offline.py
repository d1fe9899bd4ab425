"""Share of the program's ``taco.decoder`` spans inside the traced slice
in which no operation ran on the device: 1 - (union of the device
operations' intervals clipped to each span) / the spans' wall, in %.
How far the host paces the decode."""

from perfbench.spans import inside
from perfbench.trace import union_us


def read(obs):
    spans = inside(obs, "taco.decoder")
    if not spans or not obs.ops:
        return None
    wall = busy = 0.0
    for a, b in spans:
        lo, hi = a * 1e6, b * 1e6
        wall += hi - lo
        busy += union_us((max(ts, lo), min(ts + dur, hi) - max(ts, lo))
                         for _, ts, dur in obs.ops
                         if ts < hi and ts + dur > lo)
    return 100.0 * (1.0 - busy / wall)
