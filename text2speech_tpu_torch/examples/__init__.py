"""Worked examples of the port (``python -m text2speech_tpu_torch.examples.demo``,
``... .examples.corpus_drill``)."""
