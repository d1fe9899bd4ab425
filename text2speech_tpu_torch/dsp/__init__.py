"""STFT/ISTFT, DSP filters and WAV output of the PyTorch port."""
