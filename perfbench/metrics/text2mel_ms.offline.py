"""Mean wall of ``Synthesizer.text_to_mel`` per batch (text, encoder,
autoregressive decoder, postnet), from the benchmark's span around the
call, ended by a synchronise."""


def read(obs):
    spans = obs.spans_named("text_to_mel")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
