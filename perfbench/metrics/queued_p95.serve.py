"""95th percentile of the server's queue (``ContinuousBatcher.
queued_count``), read before every ``step()`` up to the traced slice (the
profiler slows the rounds it traces, and the queue after them)."""

from perfbench.traffic.common import pct


def read(obs):
    q = obs.counters.get("queued")
    if obs.slice_s is not None:
        q = [(t, v) for t, v in q or [] if t < obs.slice_s[0]]
    if not q:
        return None
    return float(pct([v for _, v in q], 95))
