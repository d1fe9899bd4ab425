"""Model FLOPs of the traced batches (text encoding, decoder steps,
postnet, upsampler and WN flows, from shapes: ``perfbench/roofline.py``)
over their wall time times the H100's bf16 peak (989 TFLOP/s), in %."""

from perfbench.roofline import PEAK_FLOPS


def read(obs):
    spans = obs.spans_named("batch")
    if not spans:
        return None
    wall = sum(b - a for a, b in spans)
    flops = sum(obs.info["batch_flops"][: len(spans)])
    return 100.0 * flops / (wall * PEAK_FLOPS["bf16"])
