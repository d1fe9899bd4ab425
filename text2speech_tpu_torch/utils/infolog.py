"""Run logging (counterpart of ``text2speech_tpu/utils/infolog.py``): every
message to stdout and, after :func:`init`, appended with a timestamp to
the run's log file.  The JAX package can also post to a Slack webhook; the
port posts nothing (it needs no network)."""

from __future__ import annotations

import atexit
from datetime import datetime

_file = None


def init(path: str, run_name: str) -> None:
    """Append this run's messages to ``path`` (``run_name`` heads the run's
    section)."""
    global _file
    close()
    _file = open(path, "a", encoding="utf-8")
    _file.write("\n" + "-" * 65 + f"\nStarting new training run {run_name}\n"
                + "-" * 65 + "\n")


def log(msg: str) -> None:
    print(msg, flush=True)
    if _file is not None:
        _file.write(f"[{datetime.now():%H:%M:%S}]  {msg}\n")
        _file.flush()


def close() -> None:
    global _file
    if _file is not None:
        _file.close()
        _file = None


atexit.register(close)
