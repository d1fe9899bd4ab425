"""Median wall of one ``ContinuousBatcher.step()`` round, from the
benchmark's span around the call (each round ends in the batcher's host
read), over the rounds outside the traced slice."""

from perfbench.traffic.common import pct


def read(obs):
    spans = obs.spans_named("step")
    if obs.slice_s is not None:
        lo, hi = obs.slice_s
        spans = [(a, b) for a, b in spans if b < lo or a > hi]
    if not spans:
        return None
    return 1e3 * pct([b - a for a, b in spans], 50)
