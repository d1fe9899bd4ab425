"""Training FLOPs of rank 0's rows (3 x the forward: upsampler and WN
flows, from shapes) over the traced steps' wall time (spans ended by a
synchronise) times the peak of the precision the step's products run
in: f32's 67 TFLOP/s with TF32 off for products and convolutions, TF32's
495 where either flag lets cuBLAS or cuDNN take TF32, in %."""

from perfbench.roofline import PEAK_FLOPS


def read(obs):
    spans = obs.spans_named("step")
    if not spans:
        return None
    wall = sum(b - a for a, b in spans)
    flops = obs.info["step_flops"] * len(spans)
    return 100.0 * flops / (wall * PEAK_FLOPS[obs.info["peak_kind"]])
