"""Run logging of the port (counterpart of ``text2speech_tpu/utils/``)."""
