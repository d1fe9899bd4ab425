"""The generator's share of its roofline over the traced batches: the sum
of the bounds of every convolution of each batch's generator pass at its
padded shape (``perfbench/roofline_vits.py``) over the device time of the
operations that start inside the benchmark's ``latent_to_audio`` spans
(the convolutions and the elementwise work between them), in %."""


def read(obs):
    spans = obs.spans_named("latent_to_audio")
    bounds = obs.info.get("generator_bound_s")
    if not spans or not bounds or not obs.ops:
        return None
    device_s = sum(dur for _, ts, dur in obs.ops
                   if any(a * 1e6 <= ts <= b * 1e6 for a, b in spans)) / 1e6
    if not device_s:
        return None
    return 100.0 * sum(bounds[: len(spans)]) / device_s
