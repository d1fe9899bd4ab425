"""Share of the generator's frames that are padding inside the traced
slice: 1 - (the program's ``vits.frames`` counter, the rows' frame
counts) / (its ``vits.frames_padded``, batch x padded frame count), in %."""


def read(obs):
    if obs.slice_s is None:
        return None
    lo, hi = obs.slice_s

    def total(name):
        return sum(v for t, v in obs.counters.get(name, []) if lo <= t <= hi)

    padded = total("vits.frames_padded")
    if not padded:
        return None
    return 100.0 * (1.0 - total("vits.frames") / padded)
