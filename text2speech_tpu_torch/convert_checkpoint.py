"""Convert a reference PyTorch checkpoint into a training checkpoint of the
port (counterpart of the root ``convert_checkpoint.py``, which writes the
JAX package's):

    python -m text2speech_tpu_torch.convert_checkpoint --kind tacotron \\
        --torch_ckpt checkpoint_10000 --out_dir converted/taco
    python -m text2speech_tpu_torch.convert_checkpoint --kind waveglow \\
        --torch_ckpt waveglow_256ch.pt --out_dir converted/wg \\
        [--config waveglow_config.json]

It writes ``<out_dir>/ckpt_00000000.pt`` (``train/checkpoint.py``): the
converted weights at step 0 with a fresh optimizer, so that ``inference
--taco_checkpoint DIR --waveglow_checkpoint DIR`` serves it and the
trainers resume from it.  The module is built on ``--device``; without a
GPU it raises, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse

import torch

from .config import HParams, WaveGlowConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", choices=["tacotron", "waveglow"], required=True)
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--hparams", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def convert(kind: str, torch_ckpt: str, out_dir: str,
            hparams: str | None = None, config: str | None = None,
            device: str = "cuda") -> int:
    """Write the port's checkpoint of ``torch_ckpt`` into ``out_dir``;
    returns the number of parameters (the JAX CLI's count)."""
    from .convert import (load_torch_checkpoint, tacotron_from_torch,
                          trainable_tacotron_from_variables,
                          trainable_waveglow_from_variables,
                          waveglow_from_torch)
    from .text import N_SYMBOLS
    from .train.checkpoint import CheckpointManager
    from .train.state import create_tacotron_state, create_train_state

    sd = load_torch_checkpoint(torch_ckpt)
    if kind == "tacotron":
        hp = HParams.load(hparams) if hparams else HParams()
        params, stats = tacotron_from_torch(sd, hp)
        n_vocab = params["embedding"]["embedding"].shape[0]
        if n_vocab != N_SYMBOLS:
            raise ValueError(f"{torch_ckpt}: the embedding has {n_vocab} "
                             f"symbols, the port's text frontend {N_SYMBOLS}")
        model = trainable_tacotron_from_variables(
            {"params": params, "batch_stats": stats}, hp, N_SYMBOLS,
            device=device)
        state = create_tacotron_state(model, hp)
    else:
        cfg = WaveGlowConfig.from_json(config) if config else WaveGlowConfig()
        model = trainable_waveglow_from_variables(
            {"params": waveglow_from_torch(sd, cfg)}, cfg, device=device)
        # the WaveGlow trainer's state: the parameter dict under its names
        state = create_train_state(model.params, cfg.learning_rate)
    mgr = CheckpointManager(out_dir)
    mgr.save(0, state)
    mgr.close()
    return sum(p.numel() for p in state.params.values())


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.convert_checkpoint needs a "
                           "CUDA GPU (no CUDA device is visible); pass "
                           "--device cpu to convert on the CPU")
    n = convert(args.kind, args.torch_ckpt, args.out_dir, args.hparams,
                args.config, args.device)
    print(f"converted {args.torch_ckpt} -> {args.out_dir} ({n:,} params)")


if __name__ == "__main__":
    main()
