"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the reference computed, worst over the sample."""

from __future__ import annotations

import torch


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64; infinite where ``got`` holds
    a non-finite value or the lengths differ."""
    got = torch.as_tensor(got).double().flatten()
    want = torch.as_tensor(want).double().flatten().to(got.device)
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf")
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def noise_power_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want||^2 / ||want||^2: the power of the difference over the
    reference's, the inverse of the signal-to-noise ratio (in dB,
    -10 log10 of it)."""
    return rel_l2(got, want) ** 2


def worst_leaf_gap(got: dict, want: dict) -> float:
    """The worst leaf's gap between two norms: |got - want| over the
    larger of the reference's norm of that leaf and of the median leaf.
    ``got`` and ``want`` map the same leaf names to norms."""
    if set(got) != set(want):
        return float("inf")
    norms = sorted(want.values())
    median = norms[len(norms) // 2]
    gap = 0.0
    for k, w in want.items():
        g = got[k]
        if g != g or g in (float("inf"), float("-inf")):
            return float("inf")
        gap = max(gap, abs(g - w) / max(w, median, 1e-30))
    return gap


def loss_gap(got: list, want: list) -> float:
    """The worst step's |loss gap| over max(|reference loss|, 1)."""
    if len(got) != len(want):
        return float("inf")
    gap = 0.0
    for g, w in zip(got, want):
        if g != g:
            return float("inf")
        gap = max(gap, abs(g - w) / max(abs(w), 1.0))
    return gap
