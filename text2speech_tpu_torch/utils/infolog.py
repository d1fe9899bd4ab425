"""Run logging (counterpart of ``text2speech_tpu/utils/infolog.py``'s
``log``).  The JAX package's copy can also append to a run's log file and
post to a Slack webhook; those are set up by the Tacotron trainer's CLI and
wait for it."""

from __future__ import annotations


def log(msg: str) -> None:
    print(msg, flush=True)
