"""WaveGlow vocoder training CLI of the PyTorch port, on one CUDA GPU:

    python -m text2speech_tpu_torch.waveglow_train -c waveglow_config.json \\
        --training_files train_files.txt --output_directory ckpt [--num_steps N]

Takes the flags of the JAX package's ``waveglow_train.py``.  It resumes from
the newest checkpoint in ``--output_directory``.  Without a GPU it raises,
unless ``--device cpu`` asks for the CPU (small configurations only).
"""

from __future__ import annotations

import argparse

import torch

from .config import WaveGlowConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", default=None,
                   help="reference-style config.json")
    p.add_argument("--training_files", default=None)
    p.add_argument("--output_directory", default="checkpoints-waveglow")
    p.add_argument("--num_steps", type=int, default=1000000)
    p.add_argument("--remat", action="store_true",
                   help="recompute each flow's WN in the backward pass: same "
                        "gradients, less activation memory, one more forward")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 matmuls and convs with f32 params and f32 loss "
                        "accumulation")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N sequential microbatches "
                        "per optimizer step (batch_size must divide by N); "
                        "gradients equal the full-batch step's")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def main(argv=None):
    """Train; returns the trainer (its state, checkpoints and last logged
    metrics) for a caller in the same process."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.waveglow_train needs a "
                           "CUDA GPU (no CUDA device is visible); pass "
                           "--device cpu to train a small configuration on "
                           "the CPU")
    from .train.waveglow import WaveGlowTrainer

    cfg = (WaveGlowConfig.from_json(args.config) if args.config
           else WaveGlowConfig())
    trainer = WaveGlowTrainer(
        cfg, args.training_files or "train_files.txt", args.output_directory,
        remat=args.remat, grad_accum=args.grad_accum, bf16=args.bf16,
        device=args.device)
    trainer.restore()
    trainer.fit(args.num_steps)
    return trainer


if __name__ == "__main__":
    main()
