#!/usr/bin/env python
"""Export the JAX package's Tacotron-2 and WaveGlow Orbax checkpoints to the
flat ``.npz`` the PyTorch port reads:

    python export_torch_weights.py --taco_checkpoint <dir> \\
        --waveglow_checkpoint <dir> --out model.npz
    python -m text2speech_tpu_torch.inference --weights model.npz \\
        --fused_vocoder --text "..."

Keys are the ``'/'``-joined flax paths of every leaf, under ``tacotron/``
and ``waveglow/`` (see ``text2speech_tpu_torch/convert.py``).  This script
is the one place where the two packages meet outside the tests.  Each
package is handed its own config dataclasses: the JAX package's restore the
checkpoints, and the port's, rebuilt from the same field values
(:func:`port_configs`), check that every array the port's modules need is
in the exported tree.
"""

from __future__ import annotations

import argparse
import dataclasses

from text2speech_tpu.config import HParams, WaveGlowConfig
from text2speech_tpu_torch import config as port_config
from text2speech_tpu_torch.convert import (flatten_tree, save_npz, sub_tree,
                                           tacotron_state_dict,
                                           waveglow_state_dict)


def export_variables(taco_variables, wg_variables) -> dict:
    """flax variable trees -> the flat ``{path: np.ndarray}`` of the file."""
    return flatten_tree({"tacotron": taco_variables,
                         "waveglow": wg_variables})


def port_configs(hp: HParams, wg_cfg: WaveGlowConfig):
    """The port's ``(HParams, WaveGlowConfig)`` with the field values of the
    JAX package's: values cross between the packages, classes do not."""
    return (port_config.HParams(**dataclasses.asdict(hp)),
            port_config.WaveGlowConfig(**dataclasses.asdict(wg_cfg)))


def check_loads_into_port(flat: dict, hp: HParams, wg_cfg: WaveGlowConfig,
                          num_speakers: int) -> None:
    """Map the exported tree onto the port's modules' state dicts; a leaf
    the port needs and the tree lacks raises ``KeyError`` here, not at
    synthesis time on the GPU."""
    port_hp, port_wg = port_configs(hp, wg_cfg)
    tacotron_state_dict(sub_tree(flat, "tacotron"), port_hp, num_speakers)
    waveglow_state_dict(sub_tree(flat, "waveglow"), port_wg)


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
    check_loads_into_port(flat, hp, wg_cfg, args.num_speakers)
    save_npz(args.out, flat)
    print(f"wrote {args.out}: {len(flat)} arrays")


if __name__ == "__main__":
    main()
