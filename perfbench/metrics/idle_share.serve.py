"""Share of the traced slice in which no operation ran on the device:
1 - (union of the device operations' intervals) / wall, in %."""

from perfbench.trace import busy_s, window_s


def read(obs):
    if not obs.ops:
        return None
    return 100.0 * (1.0 - busy_s(obs) / window_s(obs))
