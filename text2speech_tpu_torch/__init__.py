"""text2speech_tpu_torch: the PyTorch + CUDA port of ``text2speech_tpu``.

Korean TTS (Tacotron-2 + WaveGlow) on one NVIDIA H100.  The JAX package
beside it stays the reference each module here is tested against.

* ``config``  ``HParams`` and ``WaveGlowConfig``
* ``text``    the text frontend (strings -> symbol ids)
* ``models``  Tacotron-2 inference, WaveGlow (plain, fused bf16 and fused int8
  serving paths, chunked long-form synthesis), the bias-spectrum denoiser
* ``ops``     LSTM cells, the fused WN-layer CUDA kernels (bf16 and int8) and
  their build
* ``dsp``     STFT/ISTFT, filters, WAV output
* ``infer``   the ``Synthesizer`` (text -> mel -> audio -> PCM16)
* ``convert`` the bridge from the JAX package's weights to the port

The package imports nothing of ``text2speech_tpu``: ``config`` and ``text``
are its own copies, held equal to the originals by the tests.
"""

__version__ = "0.1.0"
