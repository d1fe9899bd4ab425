"""The plain float32 reference of the benchmark: Tacotron-2, WaveGlow,
the denoiser and WaveGlow's training step in PyTorch operations alone,
over the benchmark's own weights and inputs.  It imports nothing of the
system under test."""
