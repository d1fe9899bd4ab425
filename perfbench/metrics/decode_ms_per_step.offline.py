"""Host wall of one autoregressive decoder step: the program's
``taco.decoder`` spans inside the traced slice over the steps its
``taco.decoder_steps`` counter counted in them, in ms.  The host's
share of the decode (launches, Python) and the device's together; a
CUDA graph of the step moves it."""

from perfbench.spans import counted, inside


def read(obs):
    spans = inside(obs, "taco.decoder")
    steps = counted(obs, "taco.decoder_steps", spans)
    if not spans or not steps:
        return None
    return 1e3 * sum(b - a for a, b in spans) / steps
