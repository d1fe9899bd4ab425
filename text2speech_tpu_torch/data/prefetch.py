"""Background batch prefetch: the training-side IO / compute overlap
(own copy of ``text2speech_tpu/data/prefetch.py``, which imports no JAX but
sits in a package that does).

A bounded-queue producer THREAD wraps the dataset's epoch iterator.  Per
batch the host work is wav decode and numpy collation, which release the
GIL, and the mel extraction is a device call, so the producer can decode,
pad and enqueue the next batch's device work while the main thread waits on
the current train step.

Order and values are identical to consuming the iterator inline (one
producer, FIFO queue).  Exceptions in the producer re-raise at the
consumer's next pull; abandoning the generator (early ``break``,
interrupt-save) stops the producer promptly.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Yield from ``it``, assembling up to ``depth`` items ahead in a
    background thread.  ``depth=0`` degenerates to inline iteration."""
    if depth <= 0:
        yield from it
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run():
        try:
            for x in it:
                if not _put(x):
                    return
            _put(_DONE)
        except BaseException as e:  # re-raised at the consumer
            _put(_Raised(e))

    t = threading.Thread(target=_run, name="batch-prefetch", daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is _DONE:
                return
            if isinstance(x, _Raised):
                raise x.exc
            yield x
    finally:
        stop.set()
