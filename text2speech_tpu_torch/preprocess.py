"""Corpus preprocessing on one CUDA GPU:

    python -m text2speech_tpu_torch.preprocess --name kss --num_workers 8 \\
        [--in_dir datasets/kss] [--out_dir data/kss] \\
        [--trim_impl auto|device|host] [--transfer_fp16]

Takes the flags of the JAX package's ``preprocess.py`` and ``--device``:
writes one ``.npz`` per utterance and ``train.txt`` in the JAX package's
contract (:mod:`.data.preprocess`), so that either package trains from
either one's output.  Without a GPU it raises, unless ``--device cpu`` asks
for the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from . import native
from .config import HParams
from .data.preprocess import (get_transcript_parser, preprocess_corpus,
                              write_metadata)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--name", default="kss", help="dataset name")
    p.add_argument("--num_workers", type=int, default=os.cpu_count() or 8)
    p.add_argument("--in_dir", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--device_batch", type=int, default=16)
    p.add_argument("--hparams", default=None, help="path to params.json")
    p.add_argument("--trim_impl", choices=("auto", "device", "host"),
                   default="auto",
                   help="silence trim placement: 'auto' measures the copy "
                        "rate to the device and the host numpy trim rate "
                        "once and takes the cheaper; 'device' = the bounds "
                        "of whole batches on the device; 'host' = "
                        "per-utterance numpy in the IO pool")
    p.add_argument("--transfer_fp16", action="store_true",
                   help="cast the spectrograms to f16 on the device before "
                        "the copy to the host (half the bytes; the npz "
                        "stays f32, ~1e-3 relative error)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def main(argv=None) -> list:
    """Preprocess the corpus; returns the ``train.txt`` rows."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.preprocess needs a CUDA "
                           "GPU (no CUDA device is visible); pass --device "
                           "cpu to run on the CPU")
    if args.device == "cuda":
        # the STFT products in float32, as the JAX package's HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    hp = HParams.load(args.hparams) if args.hparams else HParams()
    in_dir = args.in_dir or os.path.join("datasets", args.name)
    out_dir = args.out_dir or os.path.join("data", args.name)
    try:
        from tqdm import tqdm
    except ImportError:
        def tqdm(x):
            return x

    t0 = time.time()
    metadata = preprocess_corpus(
        hp, in_dir, out_dir, num_workers=args.num_workers,
        device_batch=args.device_batch, progress=tqdm,
        parser=get_transcript_parser(args.name), trim_impl=args.trim_impl,
        transfer_fp16=args.transfer_fp16, device=args.device)
    write_metadata(metadata, out_dir, hp)
    frames = sum(int(m[4]) for m in metadata)
    dt = time.time() - t0
    lib = "built" if native.get_lib() is not None else "unavailable"
    print(f"native WAV decoder {lib}: {native.loads} files decoded natively")
    print(f"preprocessed in {dt:.1f}s ({frames / max(dt, 1e-9):.0f} mel "
          f"frames/sec)")
    return metadata


if __name__ == "__main__":
    main()
