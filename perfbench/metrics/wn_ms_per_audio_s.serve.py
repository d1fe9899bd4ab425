"""Device time of the WN-layer kernels (named ``wn_sm90_kernel``) in the
traced rounds per second of audio the server emitted in them, in ms per
audio second.  The re-vocoded window overlap counts as cost."""


def read(obs):
    ops = obs.ops_named("wn_sm90_kernel")
    samples = obs.info.get("slice_samples", 0)
    if not ops or not samples:
        return None
    audio_s = samples / obs.info["sampling_rate"]
    return sum(dur for _, _, dur in ops) / 1e3 / audio_s
