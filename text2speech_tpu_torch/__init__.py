"""text2speech_tpu_torch: the PyTorch + CUDA port of ``text2speech_tpu``.

Korean TTS (Tacotron-2 + WaveGlow) on one NVIDIA H100.  The JAX package
beside it stays the reference each module here is tested against.

* ``models``  Tacotron-2 inference, WaveGlow (plain and fused serving path),
  the bias-spectrum denoiser
* ``ops``     LSTM cells, the fused WN-layer CUDA kernels and their build
* ``dsp``     STFT/ISTFT, filters, WAV output
* ``infer``   the ``Synthesizer`` (text -> mel -> audio -> PCM16)
* ``convert`` the bridge from the JAX package's weights to the port

Hyper-parameters and the text frontend are imported from ``text2speech_tpu``
(``config`` and ``text`` pull in no JAX).
"""

__version__ = "0.1.0"
