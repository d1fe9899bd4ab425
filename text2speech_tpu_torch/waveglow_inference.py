"""Batch mel -> wav vocoder CLI of the PyTorch port, on one CUDA GPU:

    python -m text2speech_tpu_torch.waveglow_inference -f mel_files.txt \\
        -w ckpt_dir -o out/ [-s 0.6] [-d 0.1] [--fused | --int8]

Takes the flags of the JAX package's ``waveglow_inference.py``.  It reads
the ``.npy`` / ``.npz`` mels listed one per line in ``-f`` (``.npz``:
``mel`` [T, n_mel]; ``.npy``: [n_mel, T] or [T, n_mel]), vocodes each with
the newest WaveGlow training checkpoint in ``-w`` (``waveglow_train``'s),
and writes ``<name>_synthesis.wav`` (PCM16, peak-scaled) into ``-o``.

``--fused`` vocodes through the bf16 WN-layer kernels, ``--int8`` through
the int8 ones (it takes precedence); without either the plain f32 flow
runs, in bf16 matmuls and convs with ``--bf16`` (autocast; the kernel paths
are bf16 already).  ``--chunk_frames N`` vocodes a long mel in windows of
N frames plus the flows' receptive field (``models/chunked.py``); ``-d``
denoises.  The noise of the i-th file comes from a generator seeded with i.
Without a GPU it raises, unless ``--device cpu`` asks for the CPU (small
configurations only: the kernels' plain versions run there).
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from .config import WaveGlowConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-f", "--filelist_path", required=True)
    p.add_argument("-w", "--waveglow_checkpoint", required=True,
                   help="WaveGlow training checkpoint directory of this "
                        "package (waveglow_train); the newest is read")
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-s", "--sigma", type=float, default=0.6)
    p.add_argument("--sampling_rate", type=int, default=22050)
    p.add_argument("-d", "--denoiser_strength", type=float, default=0.0)
    p.add_argument("--config", default=None,
                   help="reference-style config.json")
    p.add_argument("--chunk_frames", type=int, default=0,
                   help="frame-axis chunked synthesis for long mels "
                        "(0 = single pass)")
    p.add_argument("--overlap_frames", type=int, default=None,
                   help="default: the flow stack's receptive field")
    p.add_argument("--fused", action="store_true",
                   help="vocode through the bf16 WN-layer kernels")
    p.add_argument("--int8", action="store_true",
                   help="vocode through the int8 WN-layer kernels (weights "
                        "quantized once at startup)")
    p.add_argument("--bf16", action="store_true",
                   help="run the plain vocoder's matmuls and convs in "
                        "bfloat16")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def load_mel(path: str, n_mel: int = 80) -> np.ndarray:
    """A mel file -> [n_mel, T] f32: ``.npz`` holds ``mel`` [T, n_mel]
    (preprocess output); a ``.npy`` is taken in either orientation."""
    if path.endswith(".npz"):
        mel = np.load(path)["mel"].T
    else:
        mel = np.load(path)
        if mel.shape[0] != n_mel and mel.shape[1] == n_mel:
            mel = mel.T
    return mel.astype(np.float32)


def load_vocoder(ckpt_dir: str, cfg: WaveGlowConfig, device,
                 fused: bool = False, int8: bool = False):
    """(the f32 ``WaveGlow`` of the newest checkpoint in ``ckpt_dir``, the
    vocoder that serves: that model, or its prepared bf16 or int8 kernel
    weights)."""
    from .convert import load_waveglow
    from .infer import waveglow_checkpoint
    from .models.waveglow_fused import prepare_fused, prepare_fused_int8

    model = load_waveglow(waveglow_checkpoint(ckpt_dir), cfg, device=device)
    if int8:
        return model, prepare_fused_int8(model)
    return model, prepare_fused(model) if fused else model


def main(argv=None) -> list:
    """Vocode every listed mel; returns the WAV paths written."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.waveglow_inference needs a "
                           "CUDA GPU (no CUDA device is visible); pass "
                           "--device cpu to vocode a small configuration on "
                           "the CPU")
    from .dsp.audio import save_wav
    from .models.chunked import infer_long
    from .models.denoiser import make_denoiser

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = (WaveGlowConfig.from_json(args.config) if args.config
           else WaveGlowConfig(sampling_rate=args.sampling_rate))
    model, vocoder = load_vocoder(args.waveglow_checkpoint, cfg, device,
                                  fused=args.fused, int8=args.int8)
    denoise = (make_denoiser(model)[1] if args.denoiser_strength > 0
               else None)
    plain_bf16 = args.bf16 and vocoder is model
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.filelist_path, encoding="utf-8") as f:
        paths = [line.strip() for line in f if line.strip()]
    written = []
    for i, path in enumerate(paths):
        mel = torch.from_numpy(load_mel(path, cfg.n_mel_channels))[None]
        mel = mel.to(device)
        gen = torch.Generator(device=device).manual_seed(i)
        amp = (torch.autocast(device.type, dtype=torch.bfloat16)
               if plain_bf16 else contextlib.nullcontext())
        with torch.inference_mode():
            with amp:
                if args.chunk_frames > 0:
                    audio = infer_long(vocoder, mel, args.sigma,
                                       chunk_frames=args.chunk_frames,
                                       overlap_frames=args.overlap_frames,
                                       generator=gen)
                else:
                    audio = vocoder.infer(mel, args.sigma, generator=gen)
            audio = audio.float()
            if denoise is not None:
                audio = denoise(audio, args.denoiser_strength)
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_dir, f"{name}_synthesis.wav")
        save_wav(audio[0].cpu().numpy(), out, args.sampling_rate)
        print(out)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
