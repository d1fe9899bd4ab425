"""Mean wall of ``VitsSynthesizer.latent_to_audio`` per batch (the HiFi-GAN
generator at the batch's padded frame count), from the benchmark's span
around the call, ended by a synchronise."""


def read(obs):
    spans = obs.spans_named("latent_to_audio")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
