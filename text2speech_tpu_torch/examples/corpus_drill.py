"""One-command corpus-to-audio drill of the port (counterpart of the JAX
package's ``examples/corpus_drill.py``): the reference's whole workflow on
a reference-format corpus directory, end to end.

    python -m text2speech_tpu_torch.examples.corpus_drill --in_dir /path/to/kss \\
        --work_dir work --taco_steps 50000 --wg_steps 100000 \\
        --text "안녕하세요." [--device cuda|cpu]

runs, in order (each stage is the port's real CLI, and the equivalent
standalone command is printed, so this file doubles as the recipe):

1. ``preprocess``     -- corpus dir -> npz features + train.txt
2. ``tacotron_train`` -- Tacotron-2 on the preprocessed corpus
3. ``waveglow_train`` -- WaveGlow on the corpus wavs
4. ``inference``      -- text -> wav with BOTH trained checkpoints, plus
   the alignment and mel plots

Artifacts land under ``--work_dir``:

    preprocessed/        npz features + train.txt
    tacotron/<run>/      Tacotron run dir (checkpoints/, params.json, log)
    waveglow/            WaveGlow checkpoints
    waveglow_config.json the reference-style config used (unless given)
    synth/out.wav        synthesized audio
    synth/plots/         alignment + mel spectrogram pngs

``--in_dir`` must look like the reference's KSS layout: wav files in
subdirectories plus a ``transcript.txt`` of ``path|text|normalized|N.N초``
lines.  Defaults train the full-size models (``HParams()`` / the reference
WaveGlow config); pass ``--hparams`` / ``--waveglow_config`` JSONs to scale
down.  ``--device`` goes to every stage.  The inference stage always draws
its plots, so the drill needs matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import json
import os
import shlex
import shutil
import tempfile

import numpy as np
import torch


def run_stage(module: str, argv: list) -> None:
    """Run the port's CLI ``module`` in this process, after printing the
    equivalent command."""
    argv = [str(a) for a in argv]
    name = f"text2speech_tpu_torch.{module}"
    print("\n=== " + " ".join(["python", "-m", name]
                              + [shlex.quote(a) for a in argv]), flush=True)
    importlib.import_module(name).main(argv)


def reference_config(path: str) -> None:
    """Write the reference's ``config.json`` (``waveglow/config.json:1-39``)
    of the port's default :class:`WaveGlowConfig`, so that the run's exact
    architecture rides with its artifacts."""
    from ..config import WaveGlowConfig

    c = WaveGlowConfig()
    with open(path, "w", encoding="utf-8") as f:
        json.dump({
            "train_config": {
                "learning_rate": c.learning_rate, "sigma": c.sigma,
                "iters_per_checkpoint": c.iters_per_checkpoint,
                "batch_size": c.batch_size, "seed": c.seed,
            },
            "data_config": {
                "segment_length": c.segment_length,
                "sampling_rate": c.sampling_rate,
                "filter_length": c.filter_length,
                "hop_length": c.hop_length, "win_length": c.win_length,
                "mel_fmin": c.mel_fmin, "mel_fmax": c.mel_fmax,
            },
            "waveglow_config": {
                "n_mel_channels": c.n_mel_channels,
                "n_flows": c.n_flows, "n_group": c.n_group,
                "n_early_every": c.n_early_every,
                "n_early_size": c.n_early_size,
                "WN_config": {"n_layers": c.wn_n_layers,
                              "n_channels": c.wn_n_channels,
                              "kernel_size": c.wn_kernel_size},
            },
        }, f, indent=2)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--in_dir", required=True,
                    help="reference-format corpus dir (wavs + transcript.txt)")
    ap.add_argument("--work_dir", required=True)
    ap.add_argument("--taco_steps", type=int, default=50000)
    ap.add_argument("--wg_steps", type=int, default=100000)
    ap.add_argument("--text", default="안녕하세요. 음성 합성 결과입니다.")
    ap.add_argument("--hparams", default=None,
                    help="HParams JSON (default: full-size HParams())")
    ap.add_argument("--waveglow_config", default=None,
                    help="reference-style 4-block config.json (default: "
                         "the reference WaveGlow config)")
    ap.add_argument("--device_batch", type=int, default=16)
    ap.add_argument("--sigma", type=float, default=0.666)
    ap.add_argument("--denoiser_strength", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every stage runs")
    ap.add_argument("--assert_quality", action="store_true",
                    help="after the drill, CERTIFY the trained result: "
                         "teacher-forced alignment band mass / diagonality "
                         "and trained-chain mel fidelity on training "
                         "utterances, failing loudly below the thresholds")
    ap.add_argument("--min_band_mass", type=float, default=0.40,
                    help="teacher-forced attention mass within "
                         "--quality_band tokens of the linear token<->frame "
                         "map (uniform attention scores (2*band+1)/tokens)")
    ap.add_argument("--min_align_corr", type=float, default=0.95,
                    help="attended-position/time correlation threshold")
    ap.add_argument("--min_mel_corr", type=float, default=0.30,
                    help="synthesized-audio mel correlation vs the recorded "
                         "mel of the same text (full trained chain)")
    ap.add_argument("--min_channel_match", type=float, default=0.30,
                    help="dominant-mel-channel match rate vs recorded "
                         "(chance ~= 3/n_mel)")
    ap.add_argument("--quality_band", type=int, default=1,
                    help="token slack around the linear map (widen for "
                         "natural speech; the tone corpus is exact at 1)")
    ap.add_argument("--quality_utts", type=int, default=4,
                    help="training utterances re-synthesized for the "
                         "chain-fidelity check")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the corpus drill needs a CUDA GPU (no CUDA "
                           "device is visible); pass --device cpu to run it "
                           "on the CPU")
    wd = os.path.abspath(args.work_dir)
    pp_dir = os.path.join(wd, "preprocessed")
    taco_dir = os.path.join(wd, "tacotron")
    wg_dir = os.path.join(wd, "waveglow")
    synth_dir = os.path.join(wd, "synth")
    for d in (wd, synth_dir):
        os.makedirs(d, exist_ok=True)
    dev = ["--device", args.device]
    hp_args = ["--hparams", args.hparams] if args.hparams else []

    # --- 1. preprocess ------------------------------------------------------
    run_stage("preprocess", ["--in_dir", args.in_dir, "--out_dir", pp_dir,
                             "--device_batch", args.device_batch,
                             *hp_args, *dev])

    # --- 2. Tacotron-2 training ---------------------------------------------
    run_stage("tacotron_train", ["--data_paths", pp_dir, "--log_dir",
                                 taco_dir, "--num_steps", args.taco_steps,
                                 *hp_args, *dev])
    runs = sorted((d for d in glob.glob(os.path.join(taco_dir, "*"))
                   if os.path.isdir(os.path.join(d, "checkpoints"))),
                  key=os.path.getmtime)
    if not runs:
        raise RuntimeError(f"no Tacotron run dir with checkpoints under "
                           f"{taco_dir}")
    taco_ckpt = os.path.join(runs[-1], "checkpoints")

    # --- 3. WaveGlow training -------------------------------------------------
    wavs = sorted(glob.glob(os.path.join(args.in_dir, "**", "*.wav"),
                            recursive=True))
    if not wavs:
        raise RuntimeError(f"no wavs under {args.in_dir}")
    filelist = os.path.join(wd, "waveglow_files.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(wavs))
    cfg_path = args.waveglow_config or os.path.join(wd,
                                                    "waveglow_config.json")
    if args.waveglow_config is None:
        reference_config(cfg_path)
    run_stage("waveglow_train", ["-c", cfg_path, "--training_files",
                                 filelist, "--output_directory", wg_dir,
                                 "--num_steps", args.wg_steps, *dev])

    # --- 4. synthesize with both trained checkpoints --------------------------
    out_wav = os.path.join(synth_dir, "out.wav")
    run_stage("inference", [
        "--taco_checkpoint", taco_ckpt, "--waveglow_checkpoint", wg_dir,
        "--text", args.text, "--out", out_wav, "--sigma", args.sigma,
        "--denoiser_strength", args.denoiser_strength,
        "--plot_dir", os.path.join(synth_dir, "plots"),
        "--waveglow_config", cfg_path, *hp_args, *dev])

    print("\n=== drill complete ===")
    print(f"features:    {pp_dir}")
    print(f"tacotron:    {taco_ckpt}")
    print(f"waveglow:    {wg_dir}")
    print(f"audio:       {out_wav}")
    print(f"plots:       {os.path.join(synth_dir, 'plots')}")

    if args.assert_quality:
        assert_quality(args, pp_dir, runs[-1], taco_ckpt, wg_dir, cfg_path)


def assert_quality(args, pp_dir: str, run_dir: str, taco_ckpt: str,
                   wg_dir: str, cfg_path: str) -> None:
    """Certify the trained result (``--assert_quality``): the drill must not
    just RUN the four CLIs but prove they made a model that learned.

    Gate 1, teacher-forced alignment: restore the Tacotron checkpoint and
    evaluate one corpus batch; attention must concentrate on the linear
    token<->frame band (``utils/quality.alignment_diagonality``).  Gate 2,
    the trained chain: re-synthesize training utterances' TEXT through the
    autoregressive Tacotron and WaveGlow and compare (a) the predicted mel
    and (b) the mel re-extracted from the synthesized AUDIO against the
    corpus's recorded mel (``utils/quality.mel_fidelity``).  Any metric
    below its threshold raises SystemExit with every number printed."""
    from ..config import HParams, WaveGlowConfig
    from ..dsp.audio import mel_spectrogram
    from ..infer import load_synthesizer
    from ..train.tacotron import TacotronTrainer
    from ..utils.quality import alignment_diagonality, mel_fidelity

    hp = HParams.load(args.hparams) if args.hparams else HParams()
    device = args.device
    print("\n=== quality gate (--assert_quality)")

    # --- gate 1: teacher-forced alignment diagonality ---------------------
    # the logger writes to a throwaway directory: a certification pass must
    # not write new events into the run dir it certifies
    scratch = tempfile.mkdtemp(prefix="drill_quality_tb_")
    try:
        trainer = TacotronTrainer(hp, [pp_dir], run_dir=run_dir,
                                  checkpoint_dir=taco_ckpt,
                                  logger_dir=scratch, device=device)
        step = trainer.restore()
        if step <= 0:
            raise RuntimeError(f"no restorable checkpoint under {taco_ckpt}")
        batch = trainer.dataset.sample_batch()
        _, (_, _, _, align) = trainer._eval_step(
            batch, torch.Generator(device=trainer.device).manual_seed(1))
        trainer.logger.close()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    mass, corr = alignment_diagonality(
        align.float().cpu().numpy(), batch.input_lengths.cpu().numpy(),
        batch.output_lengths.cpu().numpy(), band=args.quality_band)
    print(f"alignment: band mass {mass:.3f} (min {args.min_band_mass}), "
          f"position corr {corr:.3f} (min {args.min_align_corr}) "
          f"at step {step}")

    # --- gate 2: trained-chain fidelity on training utterances ------------
    rows = []
    with open(os.path.join(pp_dir, "train.txt"), encoding="utf-8") as f:
        for ln in f:
            parts = ln.rstrip("\n").split("|")
            if len(parts) >= 7:
                rows.append((parts[5], parts[6]))     # (text, npz_fn)
    rows = rows[: args.quality_utts]
    if not rows:
        raise RuntimeError(f"no train.txt rows under {pp_dir}")

    wg_cfg = WaveGlowConfig.from_json(cfg_path)
    synth = load_synthesizer(hp, None, wg_cfg, device=device,
                             taco_ckpt_dir=taco_ckpt, wg_ckpt_dir=wg_dir)
    texts = [t for t, _ in rows]
    target = [np.load(os.path.join(pp_dir, f))["mel"].T for _, f in rows]

    pred_mel, out_len = synth.text_to_mel(texts, seed=0)
    pred_mel = pred_mel.float().cpu().numpy()
    lengths = np.minimum(out_len.cpu().numpy(),
                         np.asarray([t.shape[-1] for t in target]))
    tmax = max(t.shape[-1] for t in target)
    tgt = np.zeros((len(target), hp.n_mel_channels, tmax), np.float32)
    for i, t in enumerate(target):
        tgt[i, :, : t.shape[-1]] = t
    m_corr, m_match = mel_fidelity(pred_mel, tgt, lengths)

    wavs = synth.synthesize(texts, sigma=args.sigma, seed=0)
    wmax = max(len(w) for w in wavs)
    wav_b = np.zeros((len(wavs), wmax), np.float32)
    for i, w in enumerate(wavs):
        wav_b[i, : len(w)] = w
    with torch.no_grad():
        audio_mel = mel_spectrogram(torch.from_numpy(wav_b).to(device),
                                    hp).float().cpu().numpy()
    a_frames = np.minimum(
        np.asarray([len(w) // hp.hop_length for w in wavs]),
        np.minimum(lengths, audio_mel.shape[-1]))
    c_corr, c_match = mel_fidelity(audio_mel, tgt, a_frames)

    print(f"mel (tacotron): corr {m_corr:.3f}, channel match {m_match:.3f}")
    print(f"mel (full chain audio): corr {c_corr:.3f}, channel match "
          f"{c_match:.3f} (min corr {args.min_mel_corr}, min match "
          f"{args.min_channel_match}; chance ~{3.0 / hp.n_mel_channels:.3f})")

    failures = []
    if mass < args.min_band_mass:
        failures.append(f"band mass {mass:.3f} < {args.min_band_mass}")
    if corr < args.min_align_corr:
        failures.append(f"align corr {corr:.3f} < {args.min_align_corr}")
    if m_corr < args.min_mel_corr:
        failures.append(f"tacotron mel corr {m_corr:.3f} < "
                        f"{args.min_mel_corr}")
    if c_corr < args.min_mel_corr:
        failures.append(f"chain mel corr {c_corr:.3f} < {args.min_mel_corr}")
    if c_match < args.min_channel_match:
        failures.append(f"chain channel match {c_match:.3f} < "
                        f"{args.min_channel_match}")
    if failures:
        raise SystemExit("QUALITY GATE FAILED: " + "; ".join(failures))
    print("quality gate PASSED")


if __name__ == "__main__":
    main()
