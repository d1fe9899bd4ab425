"""Training data of the port (counterpart of ``text2speech_tpu/data/``)."""
