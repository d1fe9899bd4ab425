"""Matplotlib (Agg) renders of an alignment, a spectrogram and the stop
gate as RGB arrays (counterpart of ``text2speech_tpu/utils/plotting.py``;
the port keeps its own copy, held equal to the JAX package's by
``tests/test_torch_plotting.py``)."""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf.copy()


def plot_alignment(alignment: np.ndarray,
                   info: str | None = None) -> np.ndarray:
    """alignment: [T_enc, T_dec] (encoder rows, decoder columns: pass
    ``align.T`` for the model's [T_dec, T_enc] output) -> RGB image
    array."""
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep" + (f"\n\n{info}" if info else "")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Encoder timestep")
    fig.tight_layout()
    return _fig_to_rgb(fig)


def plot_spectrogram(spectrogram: np.ndarray) -> np.ndarray:
    """spectrogram: [n_mel, T] -> RGB image array."""
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Frames")
    ax.set_ylabel("Channels")
    fig.tight_layout()
    return _fig_to_rgb(fig)


def plot_gate_outputs(gate_targets: np.ndarray,
                      gate_outputs: np.ndarray) -> np.ndarray:
    """Target (green) and predicted (red) stop-gate values per frame -> RGB
    image array."""
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.scatter(range(len(gate_targets)), gate_targets, alpha=0.5,
               color="green", marker="+", s=1, label="target")
    ax.scatter(range(len(gate_outputs)), gate_outputs, alpha=0.5,
               color="red", marker=".", s=1, label="predicted")
    ax.set_xlabel("Frames (Green target, Red predicted)")
    ax.set_ylabel("Gate State")
    fig.tight_layout()
    return _fig_to_rgb(fig)


def save_plots(plot_dir: str, wav_path: str, mel: np.ndarray,
               align: np.ndarray, text: str) -> tuple:
    """Write ``{stem}_alignment.png`` and ``{stem}_mel.png`` for the WAV
    at ``wav_path`` into ``plot_dir`` (root ``inference.py:14-33``).
    mel: [n_mel, T]; align: [T_dec, T_enc].  Returns the two paths."""
    import os

    os.makedirs(plot_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(wav_path))[0]
    align_png = os.path.join(plot_dir, f"{stem}_alignment.png")
    mel_png = os.path.join(plot_dir, f"{stem}_mel.png")
    plt.imsave(align_png, plot_alignment(align.T, info=text))
    plt.imsave(mel_png, plot_spectrogram(mel))
    return align_png, mel_png
