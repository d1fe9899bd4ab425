#!/usr/bin/env python
"""Export the JAX package's Tacotron-2 and WaveGlow Orbax checkpoints to the
flat ``.npz`` the PyTorch port reads:

    python export_torch_weights.py --taco_checkpoint <dir> \\
        --waveglow_checkpoint <dir> --out model.npz
    python -m text2speech_tpu_torch.inference --weights model.npz \\
        --fused_vocoder --text "..."

Keys are the ``'/'``-joined flax paths of every leaf, under ``tacotron/``
and ``waveglow/`` (see ``text2speech_tpu_torch/convert.py``).  This script
is the one place where the two packages meet outside the tests.
"""

from __future__ import annotations

import argparse

from text2speech_tpu.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.convert import flatten_tree, save_npz


def export_variables(taco_variables, wg_variables) -> dict:
    """flax variable trees -> the flat ``{path: np.ndarray}`` of the file."""
    return flatten_tree({"tacotron": taco_variables,
                         "waveglow": wg_variables})


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--taco_checkpoint", required=True)
    p.add_argument("--waveglow_checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num_speakers", type=int, default=1)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--hparams", default=None)
    p.add_argument("--waveglow_config", default=None)
    args = p.parse_args(argv)

    from text2speech_tpu.infer import load_synthesizer

    hp = (HParams.load(args.hparams) if args.hparams
          else HParams(sample_rate=args.sample_rate))
    wg_cfg = (WaveGlowConfig.from_json(args.waveglow_config)
              if args.waveglow_config
              else WaveGlowConfig(sampling_rate=args.sample_rate))
    synth = load_synthesizer(hp, args.taco_checkpoint, wg_cfg,
                             args.waveglow_checkpoint, use_denoiser=False,
                             num_speakers=args.num_speakers)
    flat = export_variables(synth.taco_variables, synth.wg_variables)
    save_npz(args.out, flat)
    print(f"wrote {args.out}: {len(flat)} arrays")


if __name__ == "__main__":
    main()
