"""Mean host wall of the program's ``synth.text`` span per batch inside
the traced slice (the text front end: symbol ids, speaker ids, their
copies to the card), in ms."""

from perfbench.spans import inside


def read(obs):
    spans = inside(obs, "synth.text")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
