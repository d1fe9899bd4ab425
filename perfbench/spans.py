"""The program's own spans and counters in a run's ``Observation``.

The port marks its layers with ``text2speech_tpu_torch/utils/profiling.py``
(``annotate``, ``count``) and keeps them, on ``time.perf_counter``, only
while a ``recording()`` is open.  A traced run opens one with
:func:`recorder` and, once the run has ended, hands it to :func:`merge`:
the program's spans join the benchmark's (their first three fields, the
layout ``Observation.spans`` holds), its counters join the benchmark's,
and ``breakdown`` then names each idle gap by the innermost span of
either.  An untraced run opens nothing, and a program without
``recording`` gives nothing to merge."""

from __future__ import annotations

from contextlib import nullcontext


def recorder(trace: bool):
    """``recording()`` of the port in a traced run; otherwise, or where the
    port has no ``recording``, a null context that yields None."""
    if not trace:
        return nullcontext(None)
    try:
        from text2speech_tpu_torch.utils.profiling import recording
    except ImportError:
        return nullcontext(None)
    return recording()


def merge(obs, rec, **info) -> None:
    """Add ``rec``'s spans and counters (``rec`` may be None) and the
    traffic's facts ``info`` to ``obs``."""
    obs.info.update(info)
    if rec is None:
        return
    obs.spans.extend(tuple(s[:3]) for s in rec.spans)
    for name, values in rec.counters.items():
        obs.counters.setdefault(name, []).extend(values)


def inside(obs, name: str) -> list:
    """(start, end) of the spans ``name`` within the traced slice."""
    if obs.slice_s is None:
        return []
    lo, hi = obs.slice_s
    return [(a, b) for a, b in obs.spans_named(name) if lo <= a and b <= hi]


def counted(obs, name: str, spans: list) -> float:
    """The sum of counter ``name``'s values taken inside ``spans``."""
    return sum(v for t, v in obs.counters.get(name, [])
               if any(a <= t <= b for a, b in spans))
