"""Mean wall of ``Synthesizer.mel_to_audio`` per batch (upsampler, the
fused WN flows, coupling, 1x1 inverses, denoiser), from the benchmark's
span around the call, ended by a synchronise."""


def read(obs):
    spans = obs.spans_named("mel_to_audio")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
