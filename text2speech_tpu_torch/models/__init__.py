"""Tacotron-2, WaveGlow and denoiser models of the PyTorch port."""
