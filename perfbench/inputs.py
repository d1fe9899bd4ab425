"""The inputs every traffic kind draws from ``--seed``: Korean texts, and
the prenet keep-masks and flow noise handed to both sides.

Every seed gets the same multiset of sizes in another order: utterance
lengths are the quantiles of the cell's log-normal at (i + 1/2) / n, and
a seed only permutes them (so a seed changes no amount of work)."""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from .reference.text import symbol_ids

MAX_SYMBOLS = 256


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A host generator for one purpose of one run."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def derived_seed(seed: int, *stream: int) -> int:
    """A seed in [0, 2**31 - 1) for one purpose of one run."""
    return int(np.random.SeedSequence([seed, *stream])
               .generate_state(1, np.uint64)[0] % (2 ** 31 - 1))


def quantile_sizes(n: int, spec: dict) -> list:
    """n sizes: the log-normal's quantiles at (i + 1/2) / n, median
    ``spec["median"]``, log-sd ``spec["sigma"]``, clipped to [min, max]."""
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        x = math.exp(math.log(spec["median"])
                     + spec["sigma"] * nd.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    return out


def korean_text(r: np.random.Generator, n_syllables: int) -> str:
    """Hangul syllables in words of 1 to 4, a period at the end, at most
    MAX_SYMBOLS symbols with EOS (trailing consonants are dropped from the
    end until it fits)."""
    syl = [[int(r.integers(19)), int(r.integers(21)),
            int(r.integers(1, 28)) if r.random() < 0.3 else 0]
           for _ in range(n_syllables)]
    breaks = set()
    i = 0
    while i < n_syllables:
        i += int(r.integers(1, 5))
        breaks.add(i)

    def render():
        chars = []
        for j, (lead, vowel, tail) in enumerate(syl):
            if j and j in breaks:
                chars.append(" ")
            chars.append(chr(0xAC00 + (lead * 21 + vowel) * 28 + tail))
        return "".join(chars) + "."

    j = n_syllables - 1
    while len(symbol_ids(render())) > MAX_SYMBOLS:
        while syl[j][2] == 0:
            j -= 1
        syl[j][2] = 0
    return render()


def texts(seed: int, stream: int, n: int, spec: dict) -> list:
    """n texts whose syllable counts are the quantile sizes, permuted by
    ``(seed, stream)``."""
    r = rng(seed, stream)
    sizes = quantile_sizes(n, spec)
    return [korean_text(r, sizes[i]) for i in r.permutation(n)]


def keep_masks(seed: int, stream: int, steps: int, rows: int,
               prenet_dim: int, device) -> torch.Tensor:
    """Prenet keep-masks bool [steps, 2, rows, prenet_dim], each kept with
    probability 1/2."""
    g = torch.Generator(device=device).manual_seed(
        derived_seed(seed, stream, 1))
    return torch.rand((steps, 2, rows, prenet_dim), generator=g,
                      device=device) < 0.5


def noise_widths(wg: dict) -> list:
    """Widths of the vocoder's standard-normal draws in consumption
    order: the initial draw, then one per early output."""
    n_early = (wg["n_flows"] - 1) // wg["n_early_every"]
    return ([wg["n_group"] - n_early * wg["n_early_size"]]
            + [wg["n_early_size"]] * n_early)


def noise(seed: int, stream: int, rows: int, groups: int, wg: dict,
          device) -> tuple:
    """The vocoder's draws for ``rows`` rows of ``groups`` sample groups,
    f32 [rows, groups, width] each."""
    g = torch.Generator(device=device).manual_seed(
        derived_seed(seed, stream, 2))
    return tuple(torch.randn((rows, groups, w), generator=g, device=device)
                 for w in noise_widths(wg))
