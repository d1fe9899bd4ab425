"""Dump log-mel spectrograms for a list of wav files, on one CUDA GPU:

    python -m text2speech_tpu_torch.mel2samp -f files.txt -o mels/ \\
        [-c waveglow_config.json]

Takes the flags of the JAX package's ``mel2samp.py``: one wav path per line
of ``-f`` (relative to the list's directory), each loaded at the config's
sampling rate and written as ``<name>.npy``, its log-mel [n_mel, frames]
f32, through the config's STFT and mel filterbank.  Without a GPU it
raises, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import WaveGlowConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-f", "--filelist_path", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-c", "--config", default=None,
                   help="reference-style config.json")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def main(argv=None) -> list:
    """Write one ``.npy`` log-mel per listed wav; returns their paths."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.mel2samp needs a CUDA GPU "
                           "(no CUDA device is visible); pass --device cpu "
                           "to run on the CPU")
    from .data.mel2samp import files_to_list
    from .dsp.audio import load_wav
    from .dsp.mel import MelFrontend

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (WaveGlowConfig.from_json(args.config) if args.config
           else WaveGlowConfig())
    fe = MelFrontend(
        filter_length=cfg.filter_length, hop_length=cfg.hop_length,
        win_length=cfg.win_length, n_mel_channels=cfg.n_mel_channels,
        sampling_rate=cfg.sampling_rate, mel_fmin=cfg.mel_fmin,
        mel_fmax=cfg.mel_fmax)
    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for path in files_to_list(args.filelist_path):
        wav = torch.from_numpy(load_wav(path, cfg.sampling_rate))[None]
        with torch.inference_mode():
            mel = fe.mel_spectrogram(wav.to(device))[0].cpu().numpy()
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_dir, f"{name}.npy")
        np.save(out, mel)
        print(out)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
