"""LSTM cells and the hand-written CUDA WN-layer kernels."""
