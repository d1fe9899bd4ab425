"""The port's plotting module (``text2speech_tpu_torch/utils/plotting.py``)
against the JAX package's, and the inference CLI's ``--plot_dir``.

The port keeps its own copy of ``text2speech_tpu/utils/plotting.py`` (it
imports nothing of the JAX package); on the same seeded inputs the three
renderers give RGB arrays equal to the JAX package's, pixel for pixel
(one matplotlib, the Agg backend, the same figure code).  ``--plot_dir``
writes ``{stem}_alignment.png`` and ``{stem}_mel.png`` beside a synthesis
on the Griffin-Lim path and on the vocoder path, as root ``inference.py``
does; both are driven here on the CPU (``synthesize_griffin_lim``,
``synthesize_offline``), and ``main`` itself on the card in
``tests/test_torch_cuda.py``.  Where matplotlib is not installed the flag
is refused before anything is synthesized."""

import os

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from text2speech_tpu.utils import plotting as jplot
from text2speech_tpu_torch import inference
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.infer import random_synthesizer
from text2speech_tpu_torch.train.checkpoint import CheckpointManager
from text2speech_tpu_torch.train.state import create_tacotron_state
from text2speech_tpu_torch.utils import plotting as tplot

torch.set_num_threads(1)

HP = HParams(
    sample_rate=8000, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, max_decoder_steps=12,
    filter_length=64, hop_length=16, win_length=64,
)
WG = WaveGlowConfig(
    n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
    n_early_size=2, wn_n_layers=2, wn_n_channels=16, upsample_kernel=64,
    upsample_stride=16, sampling_rate=8000, hop_length=16,
)
TEXT = "안녕하세요."


def _inputs():
    rng = np.random.RandomState(0)
    align = rng.rand(17, 9).astype(np.float32)
    mel = rng.randn(8, 23).astype(np.float32)
    gate_t = (np.arange(23) > 19).astype(np.float32)
    gate_o = rng.rand(23).astype(np.float32)
    return align, mel, gate_t, gate_o


@pytest.mark.parametrize("name", ["plot_alignment", "plot_spectrogram",
                                  "plot_gate_outputs"])
def test_renderers_equal_the_jax_packages(name):
    align, mel, gate_t, gate_o = _inputs()
    args = {"plot_alignment": (align.T,), "plot_spectrogram": (mel,),
            "plot_gate_outputs": (gate_t, gate_o)}[name]
    got = getattr(tplot, name)(*args)
    want = getattr(jplot, name)(*args)
    assert got.dtype == want.dtype == np.uint8 and got.ndim == 3
    assert got.shape == want.shape and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


def test_alignment_with_info_equals_the_jax_packages():
    align = _inputs()[0]
    np.testing.assert_array_equal(tplot.plot_alignment(align.T, info=TEXT),
                                  jplot.plot_alignment(align.T, info=TEXT))


def test_save_plots_writes_both_pngs(tmp_path):
    align, mel, _, _ = _inputs()
    a_png, m_png = tplot.save_plots(str(tmp_path / "plots"),
                                    "/some/where/out.wav", mel, align, TEXT)
    assert a_png == str(tmp_path / "plots" / "out_alignment.png")
    assert m_png == str(tmp_path / "plots" / "out_mel.png")
    # imsave writes the RGB render as it is (plus an alpha channel)
    read = plt.imread(m_png)
    want = jplot.plot_spectrogram(mel)
    assert read.shape[:2] == want.shape[:2]
    np.testing.assert_array_equal(
        np.round(read[..., :3] * 255).astype(np.uint8), want)
    assert plt.imread(a_png).shape[:2] == jplot.plot_alignment(
        align.T, info=TEXT).shape[:2]


@pytest.fixture(scope="module")
def synth():
    return random_synthesizer(HP, WG, 0, device="cpu", use_denoiser=False,
                              use_fused_vocoder=False)


def test_griffin_lim_path_draws_with_plot_dir(synth, tmp_path):
    ckpt = tmp_path / "taco"
    CheckpointManager(str(ckpt)).save(1, create_tacotron_state(synth.taco,
                                                               HP))
    plots = tmp_path / "plots"
    argv = ["--taco_checkpoint", str(ckpt), "--text", TEXT,
            "--griffin_lim_iters", "2", "--out", str(tmp_path / "gl.wav"),
            "--sample_rate", "8000"]
    args = inference.build_parser().parse_args(argv)
    wav, frames = inference.synthesize_griffin_lim(args, HP, WG, "cpu")
    assert not plots.exists()              # no --plot_dir, no plots
    args = inference.build_parser().parse_args(argv + ["--plot_dir",
                                                       str(plots)])
    wav2, frames2 = inference.synthesize_griffin_lim(args, HP, WG, "cpu")
    assert frames2 == frames and np.array_equal(wav2, wav)
    assert sorted(os.listdir(plots)) == ["gl_alignment.png", "gl_mel.png"]
    mel, lengths, align = synth.text_to_mel([TEXT], with_align=True)
    assert int(lengths[0]) == frames
    np.testing.assert_array_equal(
        np.round(plt.imread(plots / "gl_mel.png")[..., :3] * 255)
        .astype(np.uint8),
        tplot.plot_spectrogram(mel[0, :, :frames].numpy()))


def test_vocoder_path_draws_with_plot_dir(synth, tmp_path):
    """``synthesize_offline`` (the CLI's vocoder path): the WAV of
    ``Synthesizer.synthesize`` and, with ``--plot_dir``, both PNGs."""
    from scipy.io import wavfile

    plots = tmp_path / "plots"
    out = tmp_path / "voc.wav"
    args = inference.build_parser().parse_args(
        ["--random_init", "0", "--text", TEXT, "--out", str(out),
         "--sample_rate", "8000", "--plot_dir", str(plots), "--sigma",
         "0.5"])
    wav = inference.synthesize_offline(args, synth)
    (want,) = synth.synthesize([TEXT], sigma=0.5)
    np.testing.assert_array_equal(wav, want)
    sr, pcm = wavfile.read(out)
    assert sr == 8000 and pcm.shape == want.shape
    assert sorted(os.listdir(plots)) == ["voc_alignment.png", "voc_mel.png"]


def test_plot_dir_without_matplotlib_is_refused(monkeypatch, capsys):
    """Where matplotlib is not installed, ``--plot_dir`` exits 2 naming
    it, before anything is built or synthesized."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    with pytest.raises(SystemExit) as e:
        inference.main(["--random_init", "0", "--plot_dir", "p"])
    assert e.value.code == 2
    assert "--plot_dir draws with matplotlib" in capsys.readouterr().err
