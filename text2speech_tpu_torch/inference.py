"""Text-to-speech CLI of the PyTorch port, on one CUDA GPU:

    python -m text2speech_tpu_torch.inference --weights model.npz \\
        --text "이 것은 제작되고 있는 중입니다." --out out.wav --fused_vocoder
    python -m text2speech_tpu_torch.inference --random_init 0 --fused_vocoder

``--weights`` is the ``.npz`` written by ``export_torch_weights.py`` from the
JAX package's checkpoints; ``--random_init SEED`` synthesizes from seeded
random weights when no checkpoint exists (noise, but the whole path runs).
Without a GPU it raises: it never runs on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from text2speech_tpu.config import HParams, WaveGlowConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="flat .npz of both models "
                     "(export_torch_weights.py)")
    src.add_argument("--random_init", type=int, metavar="SEED",
                     help="seeded random weights instead of a checkpoint")
    p.add_argument("--text", default="이 것은 제작되고 있는 중입니다.")
    p.add_argument("--out", default="tone_440.wav")
    p.add_argument("--sigma", type=float, default=0.666)
    p.add_argument("--denoiser_strength", "-d", type=float, default=0.0)
    p.add_argument("--fused_vocoder", action="store_true",
                   help="vocode through the hand-written WN-layer kernels")
    p.add_argument("--speaker_id", type=int, default=None)
    p.add_argument("--num_speakers", type=int, default=1)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--hparams", default=None)
    p.add_argument("--waveglow_config", default=None)
    p.add_argument("--max_steps", type=int, default=None,
                   help="decoder steps (default: hparams max_decoder_steps)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.inference needs a CUDA GPU "
                           "(no CUDA device is visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = (HParams.load(args.hparams) if args.hparams
          else HParams(sample_rate=args.sample_rate))
    wg_cfg = (WaveGlowConfig.from_json(args.waveglow_config)
              if args.waveglow_config
              else WaveGlowConfig(sampling_rate=args.sample_rate))
    use_denoiser = args.denoiser_strength > 0
    if args.weights:
        from .infer import load_synthesizer

        synth = load_synthesizer(
            hp, args.weights, wg_cfg, use_denoiser=use_denoiser,
            num_speakers=args.num_speakers,
            use_fused_vocoder=args.fused_vocoder, device="cuda")
    else:
        from .infer import random_synthesizer

        synth = random_synthesizer(
            hp, wg_cfg, args.random_init, device="cuda",
            num_speakers=args.num_speakers, use_denoiser=use_denoiser,
            use_fused_vocoder=args.fused_vocoder)
    (wav,) = synth.synthesize_to_files(
        [args.text], [args.out], sample_rate=args.sample_rate,
        sigma=args.sigma,
        denoiser_strength=args.denoiser_strength, max_steps=args.max_steps,
        speaker_id=args.speaker_id)
    print(f"wrote {args.out} ({wav.shape[0]} samples at "
          f"{args.sample_rate} Hz)")


if __name__ == "__main__":
    main()
