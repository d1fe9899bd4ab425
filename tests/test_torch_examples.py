"""The port's two worked examples on the CPU, end to end:
``python -m text2speech_tpu_torch.examples.demo`` (the JAX demo's eleven
steps, step 6 as two tensor-parallel shards in one process) and
``python -m text2speech_tpu_torch.examples.corpus_drill`` (the port's four
CLIs in order on a 4-utterance synthetic corpus at tiny configurations,
with the quality gate's machinery run at chance-level floors, as
``tests/test_cli.py::test_corpus_drill_end_to_end`` runs the JAX drill).

The demo's step 6 is held to step 5 inside the demo (the f32 bound of
``tests/test_torch_tp_serve.py``, 1e-5); here the printed error is read
back against that bound and the two WAV files against each other: both
are peak-scaled PCM16 of audio equal to 1e-5, so they agree within one
count."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from tests.test_cli import TINY_HP
from text2speech_tpu_torch.config import HParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}


def run_module(module, argv, cwd, timeout=300):
    return subprocess.run([sys.executable, "-m", module, *map(str, argv)],
                          cwd=cwd, env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def test_demo_end_to_end(tmp_path):
    from text2speech_tpu_torch.examples.demo import TP_F32_ATOL, configs

    wd = tmp_path / "demo"
    r = run_module("text2speech_tpu_torch.examples.demo",
                   ["--workdir", wd, "--steps", 2, "--device", "cpu"],
                   cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    _, wg_cfg = configs(2)
    hop = wg_cfg.upsample_stride
    rates, data = [], []
    for name in ("out.wav", "out_tp.wav"):
        sr, pcm = wavfile.read(wd / name)
        assert pcm.dtype == np.int16 and pcm.ndim == 1
        assert pcm.size > 0 and pcm.size % hop == 0, pcm.size
        assert np.isfinite(pcm.astype(np.float64)).all()
        rates.append(sr)
        data.append(pcm.astype(np.int32))
    assert rates == [wg_cfg.sampling_rate] * 2
    samples = int(re.search(r"out\.wav \((\d+) samples\)", r.stdout)[1])
    assert data[0].size == data[1].size == samples
    assert np.abs(data[0] - data[1]).max() <= 1
    m = re.search(r"in float32; against step 5: (\d+) vs (\d+) samples, "
                  r"max_abs_err (\S+), rel_l2", r.stdout)
    assert m, r.stdout[-2000:]
    assert int(m[1]) == int(m[2]) == samples
    assert float(m[3]) <= TP_F32_ATOL
    # every step said what it did; the CPU launches no kernel
    for said in ("preprocessed 4 utterances", "tacotron trained 2 steps",
                 "waveglow trained 2 steps", "streamed", "served 2 concurrent",
                 "continuous batching: 3 requests", "HTTP serving",
                 "per-request denoiser"):
        assert said in r.stdout, said
    launches = json.loads(r.stdout.strip().splitlines()[-1]
                          .removeprefix("launches "))
    assert launches and not any(launches.values()), launches


def test_corpus_drill_end_to_end(tmp_path):
    root = tmp_path / "kss"
    (root / "1").mkdir(parents=True)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(4):
        n = 8000 + 500 * i
        t = np.arange(n) / 22050
        sig = (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)
               + 0.01 * rng.randn(n))
        wavfile.write(str(root / "1" / f"u{i}.wav"), 22050,
                      (sig * 32767).astype(np.int16))
        lines.append(f"1/u{i}.wav|안녕하세요 {i}번|안녕하세요 {i}번|1.0초")
    (root / "transcript.txt").write_text("\n".join(lines), encoding="utf-8")
    wg_cfg = {
        "train_config": {"learning_rate": 1e-4, "sigma": 1.0,
                         "iters_per_checkpoint": 2, "batch_size": 2,
                         "seed": 1},
        "data_config": {"segment_length": 2048, "sampling_rate": 22050,
                        "filter_length": 256, "hop_length": 64,
                        "win_length": 256, "mel_fmin": 0.0,
                        "mel_fmax": 8000.0},
        "waveglow_config": {"n_mel_channels": 8, "n_flows": 2, "n_group": 4,
                            "n_early_every": 4, "n_early_size": 2,
                            "upsample_kernel": 64, "upsample_stride": 64,
                            "WN_config": {"n_layers": 2, "n_channels": 16,
                                          "kernel_size": 3}},
    }
    cfg_path = tmp_path / "drill_wg.json"
    cfg_path.write_text(json.dumps(wg_cfg))
    hp_path = tmp_path / "drill_hp.json"
    HParams(**{**TINY_HP, "max_decoder_steps": 64}).save(str(hp_path))
    wd = tmp_path / "drill"
    r = run_module(
        "text2speech_tpu_torch.examples.corpus_drill",
        ["--in_dir", root, "--work_dir", wd, "--taco_steps", 2,
         "--wg_steps", 2, "--hparams", hp_path, "--waveglow_config",
         cfg_path, "--text", "안녕하세요.", "--device", "cpu",
         "--device_batch", 2,
         # the gate's machinery end to end; 2 training steps clear no real
         # threshold, so the floors are chance level
         "--assert_quality", "--min_band_mass", "0", "--min_align_corr",
         "-1", "--min_mel_corr", "-1", "--min_channel_match", "0"],
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    assert (wd / "preprocessed" / "train.txt").exists()
    taco_runs = list((wd / "tacotron").iterdir())
    assert any((d / "checkpoints" / "ckpt_00000002.pt").exists()
               for d in taco_runs)
    assert (wd / "waveglow" / "ckpt_00000002.pt").exists()
    sr, pcm = wavfile.read(wd / "synth" / "out.wav")
    assert sr == 22050 and pcm.dtype == np.int16 and pcm.size % 64 == 0
    plots = list((wd / "synth" / "plots").glob("*.png"))
    assert len(plots) >= 2, plots        # alignment + mel
    # the recipe is visible: every stage printed its standalone command
    for stage in ("preprocess", "tacotron_train", "waveglow_train",
                  "inference"):
        assert f"python -m text2speech_tpu_torch.{stage} " in r.stdout, stage
    assert r.stdout.count("--device cpu") == 4
    # the quality gate ran and reported every metric
    for said in ("alignment: band mass", "mel (tacotron): corr",
                 "mel (full chain audio): corr", "quality gate PASSED"):
        assert said in r.stdout, r.stdout[-2000:]


def test_drill_writes_the_reference_config(tmp_path):
    """Without ``--waveglow_config`` the drill writes the reference's
    ``config.json`` of the port's default ``WaveGlowConfig``, which reads
    back as that config."""
    from text2speech_tpu_torch.config import WaveGlowConfig
    from text2speech_tpu_torch.examples.corpus_drill import reference_config

    path = tmp_path / "config.json"
    reference_config(str(path))
    assert WaveGlowConfig.from_json(str(path)) == WaveGlowConfig()


def test_examples_refuse_the_missing_gpu():
    """Without a card and without ``--device cpu`` both examples raise,
    naming ``--device``, before they write anything."""
    import torch

    from text2speech_tpu_torch.examples import corpus_drill, demo

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo.main(["--workdir", "/nonexistent/demo"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        corpus_drill.main(["--in_dir", "/nonexistent", "--work_dir",
                           "/nonexistent/drill"])
