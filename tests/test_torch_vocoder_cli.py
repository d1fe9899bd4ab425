"""The port's vocoder CLIs (``text2speech_tpu_torch.waveglow_inference`` and
``.mel2samp``) at a tiny configuration on the CPU.

``mel2samp`` is held to the JAX package's ``MelFrontend.mel_spectrogram``
on the same wavs (loaded by the JAX package's ``load_wav``): the same STFT
and filterbank in f32, 1e-4 absolute on log-mels of order 1-10.

``waveglow_inference`` reads a port training checkpoint made from JAX
WaveGlow weights (every leaf perturbed, the zero-initialised end convs
included, so that each coupling moves the audio).  At ``-s 0`` no noise
reaches the audio, and its WAV is held to the JAX ``WaveGlow.infer`` on
the same weights and mel, peak-scaled to PCM16 as both CLIs write it:
the two vocoders agree to ~1e-5 of the audio's peak (``tests/
test_torch_waveglow.py``), so within 2 counts.  At ``-s 0.6`` each route
(plain, ``--fused``, ``--int8``, ``--chunk_frames``, ``-d``) is held to the
port's own library call with the generator seeded as the CLI seeds it:
the same operations, equal PCM16 samples."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from text2speech_tpu.config import WaveGlowConfig as JaxConfig
from text2speech_tpu.dsp.audio import load_wav as jax_load_wav
from text2speech_tpu.dsp.mel import MelFrontend as JaxMel
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu_torch import convert, mel2samp, waveglow_inference
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.dsp.audio import save_wav
from text2speech_tpu_torch.models.chunked import infer_long
from text2speech_tpu_torch.models.denoiser import make_denoiser
from text2speech_tpu_torch.train.checkpoint import CheckpointManager
from text2speech_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

TINY = dict(
    n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2, n_early_size=2,
    wn_n_layers=2, wn_n_channels=16, upsample_kernel=32, upsample_stride=8,
    segment_length=512, sampling_rate=8000, filter_length=64, hop_length=8,
    win_length=64, mel_fmin=0.0, mel_fmax=4000.0,
)
CFG, JCFG = WaveGlowConfig(**TINY), JaxConfig(**TINY)
FRAMES = 60
MEL_ATOL = 1e-4
JAX_PCM_COUNTS = 2


def _config_json(path) -> str:
    """TINY as a reference-style config.json."""
    data = {k: TINY[k] for k in ("segment_length", "sampling_rate",
                                 "filter_length", "hop_length", "win_length",
                                 "mel_fmin", "mel_fmax")}
    wg = {k: TINY[k] for k in ("n_mel_channels", "n_flows", "n_group",
                               "n_early_every", "n_early_size",
                               "upsample_kernel", "upsample_stride")}
    wg["WN_config"] = {"n_layers": TINY["wn_n_layers"],
                       "n_channels": TINY["wn_n_channels"]}
    path.write_text(json.dumps({"data_config": data,
                                "waveglow_config": wg}))
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A port checkpoint of perturbed JAX weights, its config.json, mel
    files in the three layouts the CLI reads, and the JAX model."""
    root = tmp_path_factory.mktemp("vocoder_cli")
    assert WaveGlowConfig.from_json(_config_json(root / "cfg.json")) == CFG
    rng = np.random.RandomState(0)
    mel = rng.randn(1, CFG.n_mel_channels, FRAMES).astype(np.float32)
    jmodel = JaxWaveGlow(JCFG)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(mel[..., :8]),
        jnp.zeros((1, 8 * CFG.upsample_stride)))
    prng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * prng.randn(*x.shape).astype(
            np.float32), variables["params"])
    model = convert.trainable_waveglow_from_variables({"params": params},
                                                      CFG)
    CheckpointManager(str(root / "ckpt")).save(
        3, create_train_state(model.params, CFG.learning_rate))
    mels = [rng.randn(CFG.n_mel_channels, FRAMES).astype(np.float32)
            for i in range(3)]
    files = [root / "a.npy", root / "b.npz", root / "c.npy"]
    np.save(files[0], mels[0])                    # [n_mel, T]
    np.savez(files[1], mel=mels[1].T)             # preprocess: [T, n_mel]
    np.save(files[2], mels[2].T)                  # [T, n_mel]
    (root / "mels.txt").write_text("\n".join(map(str, files)) + "\n")
    return {"root": root, "cfg": str(root / "cfg.json"), "mels": mels,
            "ckpt": str(root / "ckpt"), "list": str(root / "mels.txt"),
            "jmodel": jmodel, "params": params}


def _pcm(audio: np.ndarray) -> np.ndarray:
    """PCM16 as both CLIs' ``save_wav`` writes it."""
    a = np.asarray(audio, np.float32)
    return (a * (32767 / max(0.01, float(np.max(np.abs(a)))))).astype(
        np.int16)


def _cli(world, out, *flags) -> list:
    paths = waveglow_inference.main(
        ["-f", world["list"], "-w", world["ckpt"], "-o", str(out),
         "--config", world["cfg"], "--sampling_rate", "8000",
         "--device", "cpu", *flags])
    got = []
    for p in paths:
        sr, data = wavfile.read(p)
        assert sr == 8000 and data.dtype == np.int16
        got.append(data)
    return got


def test_mel_loader_takes_every_layout(world):
    for path, want in zip(open(world["list"]).read().split(), world["mels"]):
        np.testing.assert_array_equal(
            waveglow_inference.load_mel(path, CFG.n_mel_channels), want)


def test_sigma_zero_matches_jax_waveglow(world, tmp_path):
    got = _cli(world, tmp_path, "-s", "0")
    assert [g.shape[0] for g in got] == [
        m.shape[1] * CFG.upsample_stride for m in world["mels"]]
    infer = jax.jit(lambda p, mel: world["jmodel"].apply(
        {"params": p}, mel, jax.random.PRNGKey(0), 0.0,
        method=JaxWaveGlow.infer))
    for g, mel in zip(got, world["mels"]):
        want = np.asarray(infer(world["params"], jnp.asarray(mel[None])))[0]
        assert np.abs(want).max() > 0.05       # the couplings move it
        diff = np.abs(g.astype(np.int32) - _pcm(want).astype(np.int32))
        assert diff.max() <= JAX_PCM_COUNTS, diff.max()


@pytest.mark.parametrize("flags", [
    (), ("--fused",), ("--int8",), ("--int8", "--chunk_frames", "16"),
    ("--chunk_frames", "16", "-d", "0.2")],
    ids=["plain", "fused", "int8", "int8-chunked", "plain-chunked-denoised"])
def test_each_route_equals_the_library_call(world, tmp_path, flags):
    got = _cli(world, tmp_path, "-s", "0.6", *flags)
    model, voc = waveglow_inference.load_vocoder(
        world["ckpt"], CFG, "cpu", fused="--fused" in flags,
        int8="--int8" in flags)
    chunk = 16 if "--chunk_frames" in flags else 0
    den = make_denoiser(model)[1] if "-d" in flags else None
    for i, (g, mel) in enumerate(zip(got, world["mels"])):
        gen = torch.Generator().manual_seed(i)
        with torch.inference_mode():
            m = torch.from_numpy(mel)[None]
            audio = (infer_long(voc, m, 0.6, chunk_frames=chunk,
                                generator=gen) if chunk
                     else voc.infer(m, 0.6, generator=gen)).float()
            if den is not None:
                audio = den(audio, 0.2)
        assert np.array_equal(g, _pcm(audio[0].numpy()))


def test_bf16_runs_the_plain_vocoder_in_bf16(world, tmp_path):
    """``--bf16``: the plain flow under bf16 autocast, near the f32 WAV."""
    f32 = _cli(world, tmp_path / "f32", "-s", "0")
    bf16 = _cli(world, tmp_path / "bf16", "-s", "0", "--bf16")
    for a, b in zip(f32, bf16):
        assert a.shape == b.shape
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert 0 < diff.max() <= 32767 // 10


def test_mel2samp_matches_jax_frontend(world, tmp_path):
    rng = np.random.RandomState(3)
    names = []
    for i, n in enumerate((4000, 5123)):
        wav = (0.3 * np.sin(np.arange(n) * 0.05 * (i + 1))
               + 0.05 * rng.randn(n)).astype(np.float32)
        save_wav(wav, str(tmp_path / f"w{i}.wav"), 8000)
        names.append(f"w{i}.wav")
    (tmp_path / "wavs.txt").write_text("\n".join(names) + "\n")
    out = mel2samp.main(["-f", str(tmp_path / "wavs.txt"), "-o",
                         str(tmp_path / "mels"), "-c", world["cfg"],
                         "--device", "cpu"])
    fe = JaxMel(filter_length=64, hop_length=8, win_length=64,
                n_mel_channels=8, sampling_rate=8000, mel_fmin=0.0,
                mel_fmax=4000.0)
    for name, path in zip(names, out):
        assert path.endswith(name.replace(".wav", ".npy"))
        got = np.load(path)
        wav = jax_load_wav(str(tmp_path / name), 8000)
        want = np.asarray(fe.mel_spectrogram(jnp.asarray(wav[None])))[0]
        assert got.shape == want.shape == (8, 1 + wav.shape[0] // 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


def test_mel2samp_output_vocodes(world, tmp_path):
    """The pipeline the two CLIs make: wav -> mel2samp -> .npy ->
    waveglow_inference -> a WAV of frames * hop samples."""
    wav = (0.2 * np.sin(np.arange(2000) * 0.07)).astype(np.float32)
    save_wav(wav, str(tmp_path / "s.wav"), 8000)
    (tmp_path / "s.txt").write_text("s.wav\n")
    [mel] = mel2samp.main(["-f", str(tmp_path / "s.txt"), "-o",
                           str(tmp_path), "-c", world["cfg"], "--device",
                           "cpu"])
    (tmp_path / "m.txt").write_text(mel + "\n")
    [wav_out] = waveglow_inference.main(
        ["-f", str(tmp_path / "m.txt"), "-w", world["ckpt"], "-o",
         str(tmp_path / "out"), "--config", world["cfg"], "--device", "cpu",
         "--int8"])
    _, data = wavfile.read(wav_out)
    assert data.shape == (np.load(mel).shape[1] * CFG.upsample_stride,)
    assert np.abs(data).max() > 0


def test_the_clis_need_a_gpu_unless_told_otherwise(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        waveglow_inference.main(["-f", world["list"], "-w", world["ckpt"],
                                 "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        mel2samp.main(["-f", world["list"], "-o", str(tmp_path)])
