"""Set-up that only the program can shorten, in s: the union of its
set-up spans (``convert.*``: the reference-checkpoint loaders;
``synth.derive``: the fused weights and the denoiser's bias; ``ops.*``:
kernel builds and loads) that end before the traced slice.  Spans nest
strictly, so the union is the sum of the outermost ones: a nested span
is not counted twice."""

from perfbench.trace import union_us

SETUP = ("convert.", "synth.derive", "ops.")


def read(obs):
    if obs.slice_s is None:
        return None
    spans = [(a, b) for n, a, b in obs.spans
             if n.startswith(SETUP) and b <= obs.slice_s[0]]
    if not spans:
        return None
    return union_us((a, b - a) for a, b in spans)
