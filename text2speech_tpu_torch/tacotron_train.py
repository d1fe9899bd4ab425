"""Tacotron-2 training CLI of the PyTorch port, on one CUDA GPU:

    python -m text2speech_tpu_torch.tacotron_train --data_paths ./datasets/kss \\
        [--load_path <run dir to resume>] [--num_steps N] [--bf16] [--remat]

Takes the flags of the JAX package's root ``train.py``; several
comma-separated data paths train a multi-speaker model (the speaker id is
the corpus index).  It resumes from the newest checkpoint of the run's
checkpoint directory; ``--checkpoint_file`` warm-starts from another run's.
Without a GPU it raises, unless ``--device cpu`` asks for the CPU (small
configurations only).  Under torchrun it trains data-parallel on the most
ranks that divide the batch (``python -m torch.distributed.run
--nproc_per_node N -m text2speech_tpu_torch.tacotron_train ...``); rank 0
makes the run directory and writes its files.
"""

from __future__ import annotations

import argparse
import os

import torch

from .config import HParams
from .utils import infolog
from .utils.run_dirs import load_hparams, make_run_dir, save_hparams, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_paths", default="./datasets/kss")
    p.add_argument("--load_path", default=None,
                   help="previous run dir to resume (reloads its hparams)")
    p.add_argument("--checkpoint_file", default=None,
                   help="another run's checkpoint directory to warm-start "
                        "from")
    p.add_argument("--wav_dir", default="./wav/",
                   help="accepted for the reference CLI's sake and unused, "
                        "as in the reference")
    p.add_argument("--log_dir", default="logdir-tacotron")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--logger_path", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_test_per_speaker", type=int, default=2)
    p.add_argument("--random_seed", type=int, default=123)
    p.add_argument("--skip_path_filter", type=str2bool, default=False)
    p.add_argument("--checkpoint_interval", type=int, default=1000)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--hparams", default=None,
                   help="params.json overriding the defaults")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 matmuls and convs with f32 params and f32 loss "
                        "accumulation")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N sequential microbatches "
                        "per optimizer step (batch_size must divide by N)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each decoder step in the backward pass: "
                        "same loss, one step's activations kept")
    p.add_argument("--data_format", choices=["auto", "wav", "npz"],
                   default="auto",
                   help="'npz' trains from preprocess output (auto-detected "
                        "when the data paths hold .npz files)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def main(argv=None):
    """Train; returns the trainer (its state, checkpoints and last metrics)
    for a caller in the same process."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.tacotron_train needs a "
                           "CUDA GPU (no CUDA device is visible); pass "
                           "--device cpu to train a small configuration on "
                           "the CPU")
    import torch.distributed as dist

    from .parallel.mesh import distributed_banner, initialize_distributed
    from .train.tacotron import TacotronTrainer

    own = not dist.is_initialized()
    distributed = initialize_distributed(device=args.device)
    chief = not distributed or dist.get_rank() == 0
    data_paths = args.data_paths.split(",")
    if args.load_path:
        run_dir = args.load_path
        hp = load_hparams(run_dir)
    else:
        # one run directory, named by rank 0's clock
        run_dir = (make_run_dir(args.log_dir,
                                os.path.basename(data_paths[0].rstrip("/")))
                   if chief else None)
        if distributed:
            box = [run_dir]
            dist.broadcast_object_list(box, src=0)
            run_dir = box[0]
        hp = HParams.load(args.hparams) if args.hparams else HParams()
    if args.batch_size:
        hp = hp.replace(batch_size=args.batch_size)
    hp = hp.replace(seed=args.random_seed,
                    checkpoint_interval=args.checkpoint_interval)
    if distributed:         # every rank has read params.json before
        dist.barrier()      # rank 0 writes it again
    if chief:
        save_hparams(run_dir, hp)
        infolog.init(os.path.join(run_dir, "train.log"),
                     os.path.basename(run_dir))
    if distributed:
        infolog.log(distributed_banner())
    try:
        trainer = TacotronTrainer(
            hp, data_paths, run_dir, checkpoint_dir=args.checkpoint_path,
            logger_dir=args.logger_path,
            num_test_per_speaker=args.num_test_per_speaker,
            skip_path_filter=args.skip_path_filter,
            data_format=args.data_format, remat=args.remat,
            grad_accum=args.grad_accum, bf16=args.bf16, device=args.device)
        trainer.restore(args.checkpoint_file)
        trainer.fit(args.num_steps)
    finally:
        infolog.close()
    if own:
        from .parallel.mesh import destroy_distributed

        destroy_distributed()
    return trainer


if __name__ == "__main__":
    main()
