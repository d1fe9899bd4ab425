"""Mean wall of ``VitsSynthesizer.text_to_latent`` per batch (text,
encoder, duration predictor, the host read of the frame counts,
expansion, flows), from the benchmark's span around the call, ended by a
synchronise."""


def read(obs):
    spans = obs.spans_named("text_to_latent")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
