"""End-to-end parity of the port's synthesis path with the JAX package's:
STFT / ISTFT / denoiser, and ``Synthesizer(use_fused_vocoder=True)`` with
the denoiser against ``text2speech_tpu.infer.Synthesizer`` given the same
weights, prenet masks and vocoder noise.  Plus the port's two promises
about its surroundings: it imports with JAX blocked, and its CUDA entry
raises without ``nvcc`` instead of falling back."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2speech_tpu.config import HParams, WaveGlowConfig
from text2speech_tpu.dsp import stft as jstft
from text2speech_tpu.infer import Synthesizer as JaxSynthesizer
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.dsp import stft as tstft
from text2speech_tpu_torch.infer import Synthesizer
from text2speech_tpu_torch.ops.build import CSRC_DIR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HP = HParams(
    sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, max_decoder_steps=20,
)
WG = WaveGlowConfig(
    n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
    n_early_size=2, wn_n_layers=3, wn_n_channels=16, upsample_kernel=64,
    upsample_stride=16, sampling_rate=22050, hop_length=16,
)
DKW = dict(filter_length=64, n_overlap=4, win_length=64, n_frames=16)


@pytest.mark.parametrize("n", [4000, 4097])
def test_stft_istft_denoise_match_jax(n):
    """f32 DFT matmuls on both sides (JAX at HIGHEST precision): 1e-4 on
    magnitudes of order 10, 2e-5 on the resynthesized signal."""
    rng = np.random.RandomState(n)
    y = rng.randn(2, n).astype(np.float32)
    params = jstft.STFTParams(256, 64, 256)
    tparams = tstft.STFTParams(256, 64, 256)
    jm, jp = jstft.stft_mag_phase(jnp.asarray(y), params)
    tm, tp = tstft.stft_mag_phase(torch.from_numpy(y), tparams)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
    bias = np.abs(rng.randn(1, 129, 1)).astype(np.float32)
    den_j = jstft.istft(jnp.maximum(jm - jnp.asarray(bias) * 0.1, 0.0), jp,
                        params)
    den_t = tstft.istft(torch.clamp_min(tm - torch.from_numpy(bias) * 0.1,
                                        0.0), tp, tparams)
    assert den_t.shape == den_j.shape == (2, 64 * (n // 64))
    np.testing.assert_allclose(den_t.numpy(), np.asarray(den_j), atol=2e-5)


def test_denoiser_matches_jax(pair):
    """The bias spectrum (plain f32 vocoder on an all-zero mel at sigma=0,
    first STFT frame) and a denoised signal, against JAX's
    ``make_denoiser`` on the same weights: f32 throughout, 1e-5."""
    from text2speech_tpu.models.denoiser import make_denoiser as jax_den
    from text2speech_tpu_torch.models.denoiser import make_denoiser

    _, _, jsyn, tsyn = pair
    jbias, jden = jax_den(jsyn.waveglow, jsyn.wg_variables, **DKW)
    tbias, tden = make_denoiser(tsyn.waveglow, **DKW)
    np.testing.assert_allclose(tbias.numpy(), np.asarray(jbias), atol=1e-5)
    y = np.random.RandomState(9).randn(2, 1000).astype(np.float32)
    np.testing.assert_allclose(tden(torch.from_numpy(y), 0.5).numpy(),
                               np.asarray(jden(jnp.asarray(y), 0.5)),
                               atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """The JAX Synthesizer and the port's, on the same perturbed weights."""
    rng = jax.random.PRNGKey(0)
    taco = JaxTacotron2(HP, n_vocab=N_SYMBOLS)
    tvars = taco.init({"params": rng, "dropout": rng},
                      jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
                      jnp.zeros((1, HP.n_mel_channels, 8)), jnp.asarray([8]))
    wg = JaxWaveGlow(WG)
    wvars = wg.init(rng, jnp.zeros((1, WG.n_mel_channels, 16)),
                    jnp.zeros((1, 16 * WG.upsample_stride)))
    prng = np.random.RandomState(1)
    wparams = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * prng.randn(*x.shape).astype(
            np.float32), wvars["params"])
    jsyn = JaxSynthesizer(
        hp=HP, taco=taco, taco_variables=tvars, wg_cfg=WG, waveglow=wg,
        wg_variables={"params": wparams}, use_denoiser=True,
        use_fused_vocoder=True, denoiser_kwargs=DKW)
    tsyn = Synthesizer(
        HP, convert.load_tacotron(tvars, HP, N_SYMBOLS), WG,
        convert.load_waveglow({"params": wparams}, WG),
        use_denoiser=True, use_fused_vocoder=True, denoiser_kwargs=DKW)
    return taco, tvars, jsyn, tsyn


def _jax_draws(taco, tvars, seed, Tg, B):
    """Prenet masks from PRNGKey(seed) (``Tacotron2.derive_rng``; split
    into one key per step; per step a prenet/step split; per prenet layer
    a split and ``bernoulli(0.5)``) and the fused vocoder's noise from
    PRNGKey(seed + 1), split as ``waveglow_fused.py:389-392``: drawn in
    bf16 at the tile-rounded length, then cut to the true length."""
    rng = taco.apply(tvars, method=JaxTacotron2.derive_rng,
                     rngs={"dropout": jax.random.PRNGKey(seed)})
    masks = []
    for rng_t in jax.random.split(rng, HP.max_decoder_steps):
        rng_pre, _ = jax.random.split(rng_t)
        layers = []
        for _ in range(2):
            rng_pre, sub = jax.random.split(rng_pre)
            layers.append(np.asarray(jax.random.bernoulli(
                sub, 0.5, (B, HP.prenet_dim))))
        masks.append(np.stack(layers))
    keep = torch.from_numpy(np.stack(masks))
    key = jax.random.PRNGKey(seed + 1)
    Tp = max(-(-Tg // 512) * 512, 512)
    widths = [WG.n_remaining_channels] + [
        WG.n_early_size for k in reversed(range(WG.n_flows))
        if k % WG.n_early_every == 0 and k > 0]
    noise = []
    for c in widths:
        key, sub = jax.random.split(key)
        z = jax.random.normal(sub, (B, Tp, c), jnp.bfloat16)
        noise.append(torch.from_numpy(
            np.asarray(z.astype(jnp.float32))[:, :Tg].copy()))
    return keep, tuple(noise)


def test_synthesizer_matches_jax(pair):
    """Fused bf16 vocoder + denoiser, end to end.  Mels: f32 on both sides,
    1e-4.  Audio: both vocoders round to bf16 at the same points of the
    same arithmetic, but a float32 sum taken in another order can land on
    the other side of a bf16 rounding boundary.  The audio is held in bf16
    between flows, so such flips are one bf16 step (2^-8 of the value) on
    scattered samples: measured 1 step at the peak and 0.6% relative L2.
    The denoiser then resynthesizes, so a step taken at a larger value
    before it can land on a smaller sample after it.  Bounds: 4 steps at
    the peak (2^-6 of max |audio|) and 2e-2 relative L2."""
    taco, tvars, jsyn, tsyn = pair
    texts = ["안녕하세요.", "존경하는 사람"]
    seed = 3
    jmel, jlen = jsyn.text_to_mel(texts, seed)
    jlen = np.asarray(jlen)
    Tg = int(jlen.max()) * WG.upsample_stride // WG.n_group
    keep, noise = _jax_draws(taco, tvars, seed, Tg, len(texts))

    tmel, tlen = tsyn.text_to_mel(texts, seed, keep_masks=keep)
    np.testing.assert_array_equal(tlen.numpy(), jlen)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=1e-4)

    want = jsyn.synthesize(texts, seed=seed, denoiser_strength=0.1)
    got = tsyn.synthesize(texts, seed=seed, denoiser_strength=0.1,
                          keep_masks=keep, noise=noise)
    for g, w, n in zip(got, want, jlen):
        assert g.shape == w.shape == (int(n) * WG.upsample_stride,)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=2.0 ** -6 * np.abs(w).max())
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 2e-2, rel


def test_text_to_mel_with_align_matches_jax(pair):
    """``with_align=True`` returns the attention alignment [B, T_dec, T_enc]
    beside the mel, as the JAX method does.  Both sides run the decoder in
    f32 on the same weights and prenet masks; the alignment is a softmax
    over the encoder positions of every step, so it agrees as the mel does,
    to a few f32 ulps carried through the steps: 1e-5."""
    taco, tvars, jsyn, tsyn = pair
    texts = ["안녕하세요.", "존경하는 사람"]
    seed = 5
    jmel, jlen, jalign = jsyn.text_to_mel(texts, seed, with_align=True)
    jlen = np.asarray(jlen)
    Tg = int(jlen.max()) * WG.upsample_stride // WG.n_group
    keep, _ = _jax_draws(taco, tvars, seed, Tg, len(texts))
    tmel, tlen, talign = tsyn.text_to_mel(texts, seed, keep_masks=keep,
                                          with_align=True)
    np.testing.assert_array_equal(tlen.numpy(), jlen)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=1e-4)
    assert talign.dtype == torch.float32
    assert tuple(talign.shape) == np.asarray(jalign).shape
    np.testing.assert_allclose(talign.numpy(), np.asarray(jalign), atol=1e-5)
    mel_only = tsyn.text_to_mel(texts, seed, keep_masks=keep)
    assert len(mel_only) == 2 and torch.equal(mel_only[0], tmel)


def test_synthesize_to_files_writes_pcm16(pair, tmp_path):
    from scipy.io import wavfile

    *_, tsyn = pair
    paths = [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    wavs = tsyn.synthesize_to_files(["가나다.", "라마"], paths, seed=1,
                                    denoiser_strength=0.1)
    for p, w in zip(paths, wavs):
        sr, data = wavfile.read(p)
        assert sr == WG.sampling_rate and data.dtype == np.int16
        assert data.shape == w.shape and np.abs(data).max() > 0


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    (and flax, optax, orbax, triton) fails, and so does any import of the
    JAX package ``text2speech_tpu``: the port keeps its own ``config`` and
    ``text``."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'triton',\n"
        "          'text2speech_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import text2speech_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "importlib.import_module('text2speech_tpu_torch.inference')\n"
        "for n in ('ops.gated', 'ops.wn_backward', 'train.waveglow',\n"
        "          'train.checkpoint', 'data.mel2samp', 'utils.logger',\n"
        "          'waveglow_train', 'ops.wn_block_dcond',\n"
        "          'models.tacotron_serve', 'parallel', 'parallel.tp',\n"
        "          'server', 'http_serve', 'ops.wn_block_padded',\n"
        "          'train.tacotron', 'train.state', 'data.dataset',\n"
        "          'data.npz_dataset', 'utils.run_dirs', 'utils.infolog',\n"
        "          'tacotron_train', 'waveglow_inference', 'mel2samp',\n"
        "          'data.preprocess', 'native', 'preprocess',\n"
        "          'parallel.mesh', 'utils.plotting',\n"
        "          'parallel.tp_tacotron', 'parallel.serve',\n"
        "          'convert', 'convert_checkpoint', 'utils.quality',\n"
        "          'utils.profiling', 'examples', 'examples.demo',\n"
        "          'examples.corpus_drill',\n"
        "          'examples.reference_checkpoints', 'ops.vits_conv'):\n"
        "    assert pkg.__name__ + '.' + n in names, n\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


def test_cuda_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc -> the build raises; nothing falls back to a plain path."""
    from text2speech_tpu_torch.ops import build, wn_block

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    lib = build.CudaLibrary("wn_block_sm90", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wn_block.LIB_SM90.build()


def _declared_libraries() -> list:
    """Every ``CudaLibrary`` the modules of ``text2speech_tpu_torch.ops``
    declare, each once (a module may import another's)."""
    import importlib
    import pkgutil

    from text2speech_tpu_torch import ops
    from text2speech_tpu_torch.ops.build import CudaLibrary

    libs = {}
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{m.name}")
        libs.update((id(v), v) for v in vars(mod).values()
                    if isinstance(v, CudaLibrary))
    return list(libs.values())


@pytest.mark.parametrize("source", sorted(
    p.name for p in CSRC_DIR.glob("*.cu")))
def test_every_kernel_source_is_one_librarys(source):
    """Each ``csrc/*.cu`` is the source of exactly one ``CudaLibrary`` of
    ``ops/``, and every declared library's source exists: a kernel file
    that nothing loads, or a library without its file, fails here."""
    libs = _declared_libraries()
    assert [lib.source.name for lib in libs].count(source) == 1
    assert all(lib.source.is_file() for lib in libs)


def test_exported_npz_loads_into_the_port(pair, tmp_path, monkeypatch):
    """JAX-initialised tiny models -> ``export_torch_weights.py`` -> .npz ->
    ``load_synthesizer``: the port holds exactly the weights it holds when
    built from the trees, and synthesizes the same audio."""
    import export_torch_weights as exp
    from text2speech_tpu_torch.infer import load_synthesizer

    taco, tvars, jsyn, tsyn = pair

    class Restored:  # what text2speech_tpu.infer.load_synthesizer returns
        taco_variables = tvars
        wg_variables = jsyn.wg_variables

    seen = {}

    def fake_load(hp, taco_dir, wg_cfg, wg_dir, use_denoiser, num_speakers):
        seen.update(taco=taco_dir, wg=wg_dir, n=num_speakers)
        return Restored

    monkeypatch.setattr("text2speech_tpu.infer.load_synthesizer", fake_load)
    out = str(tmp_path / "model.npz")
    # the exporter checks the tree against the port's modules at the
    # widths it is told, so it is told the tiny models' widths
    HP.save(str(tmp_path / "hp.json"))
    (tmp_path / "wg.json").write_text(json.dumps({"waveglow_config": {
        "n_mel_channels": WG.n_mel_channels, "n_flows": WG.n_flows,
        "n_group": WG.n_group, "n_early_every": WG.n_early_every,
        "n_early_size": WG.n_early_size,
        "upsample_kernel": WG.upsample_kernel,
        "upsample_stride": WG.upsample_stride,
        "WN_config": {"n_layers": WG.wn_n_layers,
                      "n_channels": WG.wn_n_channels}}}))
    exp.main(["--taco_checkpoint", "t_dir", "--waveglow_checkpoint", "w_dir",
              "--out", out, "--num_speakers", "1",
              "--hparams", str(tmp_path / "hp.json"),
              "--waveglow_config", str(tmp_path / "wg.json")])
    assert seen == {"taco": "t_dir", "wg": "w_dir", "n": 1}
    port_hp, port_wg = exp.port_configs(HP, WG)
    assert type(port_hp) is not type(HP) and port_hp.__dict__ == HP.__dict__
    assert port_wg.__dict__ == WG.__dict__
    with pytest.raises(KeyError):      # a tree that lacks what the port needs
        exp.check_loads_into_port({}, HP, WG, 1)

    loaded = load_synthesizer(HP, out, WG, use_denoiser=False,
                              use_fused_vocoder=True, device="cpu")
    for a, b in ((loaded.taco, tsyn.taco), (loaded.waveglow, tsyn.waveglow)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    texts = ["가나다."]
    got = loaded.synthesize(texts, seed=5)
    want = tsyn.synthesize(texts, seed=5)
    np.testing.assert_array_equal(got[0], want[0])


def test_cli_raises_without_gpu():
    """The port's CLI takes the root CLI's flags and refuses to run on the
    CPU: with no CUDA device it raises before building anything."""
    from text2speech_tpu_torch import inference

    argv = ["--random_init", "0", "--fused_vocoder", "-d", "0.1",
            "--text", "안녕", "--sigma", "0.5", "--speaker_id", "0",
            "--num_speakers", "2", "--sample_rate", "22050"]
    args = inference.build_parser().parse_args(argv)
    assert args.fused_vocoder and args.random_init == 0
    assert not args.int8_vocoder
    argv8 = ["--random_init", "1", "--int8_vocoder", "--max_steps", "10"]
    args8 = inference.build_parser().parse_args(argv8)
    assert args8.int8_vocoder and not args8.fused_vocoder
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for a in (argv, argv8):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            inference.main(a)
