"""Model FLOPs of the audio emitted in the traced rounds (decoder,
postnet, upsampler and WN flows per emitted frame, the encoder spread
over the frames; the overlap's re-vocoding not counted) over the traced
slice's wall time times the H100's bf16 peak (989 TFLOP/s), in %."""

from perfbench.roofline import PEAK_FLOPS
from perfbench.trace import window_s


def read(obs):
    samples = obs.info.get("slice_samples", 0)
    if not samples or obs.slice_s is None:
        return None
    frames = samples / obs.info["hop"]
    flops = frames * obs.info["flops_per_frame"]
    return 100.0 * flops / (window_s(obs) * PEAK_FLOPS["bf16"])
