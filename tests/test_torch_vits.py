"""VITS in the port (``models/vits.py``, ``infer.VitsSynthesizer``) against
the plain float32 reference (``perfbench/reference/vits.py``) on seeded
random weights, on the CPU: each part alone (relative attention, the
spline both ways, the duration predictor, the expansion, the coupling
flows, the generator), the whole ``synthesize`` on a batch of unequal
lengths, the blanks of ``encode_batch`` and the CLI.  One case runs at the
published widths on a short text.

Tolerances: both sides compute in float32 with other orders of
operations (GEMMs over unfolded taps against convolutions, a gather
against the path matrix, diagonals against pad-and-reshape), so the
float32 parts agree to a few ulps of accumulated rounding: 1e-5 relative
(the chain reads ~1e-6).  The bf16 generator rounds every activation to 8
bits of mantissa: 5e-3 noise-to-signal power."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import inputs, weights_vits
from perfbench.reference import vits as ref
from perfbench.reference.text import symbol_ids
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import VitsConfig
from text2speech_tpu_torch.infer import VitsSynthesizer
from text2speech_tpu_torch.models import vits as port
from text2speech_tpu_torch.text import (PAD_ID, encode_batch, intersperse,
                                        text_to_sequence)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                  "vits-ljs.json"), encoding="utf-8"))
F32_TOL = 1e-5
BF16_NSR = 5e-3
SPEC = {"median": 6, "sigma": 0.5, "min": 3, "max": 10}


def small_cfg() -> dict:
    cfg = copy.deepcopy(CFG)
    cfg["vits"].update(hidden_channels=32, inter_channels=16,
                       filter_channels=48, dp_filter_channels=32,
                       upsample_initial_channel=32, n_layers=2)
    return cfg


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).norm() / b.norm()).item()


def f32_module(sd, vc: VitsConfig) -> port.Vits:
    """The loader's module with the generator left in float32 (the
    loader casts it to bf16; the weights are then rounded)."""
    model = port.Vits(vc, "cpu")
    model.load_state_dict(convert.vits_state_dict(sd, vc))
    return model.eval()


@pytest.fixture(scope="module")
def small():
    cfg = small_cfg()
    sd = weights_vits.make_weights(cfg, 2 ** 31 + 5, "cpu")
    vc = VitsConfig.from_dict(cfg["vits"])
    model = f32_module(sd, vc)
    return cfg["vits"], sd, vc, model


def _row_ids(texts):
    return [ref.intersperse(symbol_ids(t)) for t in texts]


def _encode(model, texts):
    ids, lengths = encode_batch(texts, add_blank=True)
    ids, lengths = torch.from_numpy(ids).long(), torch.from_numpy(lengths)
    mask = torch.arange(ids.shape[1])[None] < lengths[:, None]
    return ids, lengths, mask


@pytest.mark.parametrize("n_syl", [1, 2, 7])
def test_relative_attention_and_encoder(small, n_syl):
    """Rows padded into one batch equal the reference's unpadded rows, at
    lengths below, near and above the window (1 syllable: 7 symbols)."""
    v, sd, _, model = small
    texts = ["가" * n_syl + ".", "나다" * (n_syl + 2) + "."]
    ids, _, mask = _encode(model, texts)
    with torch.no_grad():
        x, m_p, logs_p = model.enc(ids, mask)
    for i, row in enumerate(_row_ids(texts)):
        n = len(row)
        rx, rm, rl, _ = ref.text_encoder(sd, v, torch.tensor([row]))
        assert rel(x[i, :n].T, rx[0]) < F32_TOL
        assert rel(m_p[i, :n].T, rm[0]) < F32_TOL
        assert rel(logs_p[i, :n].T, rl[0]) < F32_TOL
        assert x[i, n:].abs().max() == 0 if n < x.shape[1] else True


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_against_the_reference(inverse):
    g = torch.Generator().manual_seed(3)
    x = 4 * torch.randn(2, 300, generator=g)          # some beyond +-5
    x[0, :3] = torch.tensor([-5.0, 5.0, 0.0])
    uw, uh = torch.randn(2, 300, 10, generator=g), torch.randn(2, 300, 10,
                                                               generator=g)
    ud = torch.randn(2, 300, 9, generator=g)
    got = port.rq_spline(x, uw, uh, ud, 5.0, inverse=inverse)
    want, _ = ref.spline(x, uw, uh, ud, inverse=inverse, tail_bound=5.0)
    assert (x.abs() > 5).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    back = port.rq_spline(got, uw, uh, ud, 5.0, inverse=not inverse)
    torch.testing.assert_close(back, x, rtol=1e-4, atol=1e-4)


def test_duration_predictor(small):
    v, sd, _, model = small
    texts = inputs.texts(11, 0, 3, SPEC)
    ids, lengths, mask = _encode(model, texts)
    g = torch.Generator().manual_seed(4)
    noise = torch.randn(3, 2, ids.shape[1] + 5, generator=g)
    with torch.no_grad():
        _, _, logw, m = model.encode(ids, lengths, noise, 0.8)
    for i, row in enumerate(_row_ids(texts)):
        n = len(row)
        x, _, _, xm = ref.text_encoder(sd, v, torch.tensor([row]))
        want = ref.duration_predictor(sd, v, x, xm, noise[i:i + 1, :, :n]
                                      * 0.8)
        assert rel(logw[i, :n], want[0, 0]) < F32_TOL
        assert logw[i, n:].abs().max() == 0 if n < logw.shape[1] else True


@pytest.mark.parametrize("T_y", [40, 64])
def test_expansion_equals_the_path_matrix(T_y):
    g = torch.Generator().manual_seed(5)
    m_p, logs_p = torch.randn(3, 9, 4, generator=g), torch.randn(3, 9, 4,
                                                                 generator=g)
    w = torch.randint(0, 6, (3, 9), generator=g).float()
    w[1] = 0                                          # total 0: y_len 1
    w[2, 6:] = 0                                      # padded symbols
    m, logs = port.Vits.expand(m_p, logs_p, w, T_y)
    for i in range(3):
        cum = int(w[i].sum())
        mask = torch.zeros(1, 1, T_y, 9)
        mask[..., : max(cum, 1), :] = 1
        path = ref.generate_path(w[i].view(1, 1, 9), mask)[0, 0]
        assert torch.equal(m[i], path @ m_p[i])
        assert torch.equal(logs[i], path @ logs_p[i])


def test_coupling_flows(small):
    v, sd, _, model = small
    g = torch.Generator().manual_seed(6)
    C, T = v["inter_channels"], 48
    z_p = torch.randn(2, T, C, generator=g)
    y_len = torch.tensor([48, 29])
    y_mask = (torch.arange(T)[None] < y_len[:, None])[..., None].float()
    with torch.no_grad():
        z = model.flow_reverse(z_p, y_mask)
    for i in range(2):
        n = int(y_len[i])
        want = ref.flow_reverse(sd, v, z_p[i:i + 1, :n].transpose(1, 2),
                                torch.ones(1, 1, n))
        assert rel(z[i, :n].T, want[0]) < F32_TOL
        assert z[i, n:].abs().max() == 0 if n < T else True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generator(small, dtype):
    v, sd, vc, _ = small
    model = (f32_module(sd, vc) if dtype == torch.float32
             else convert.vits_module_from_torch(sd, vc, "cpu"))
    assert model.dec.pre_w.dtype == dtype
    g = torch.Generator().manual_seed(7)
    z = torch.randn(2, v["inter_channels"], 13, generator=g)
    with torch.no_grad():
        got = model.dec(z)
    want = ref.generator(sd, v, z)[:, 0]
    assert got.dtype == torch.float32 and got.shape == (2, 13 * vc.hop)
    nsr = rel(got, want) ** 2
    assert nsr < (F32_TOL ** 2 if dtype == torch.float32 else BF16_NSR)
    assert 0.05 < want.pow(2).mean().sqrt() < 0.9     # tanh off its rails


def _check_rows(sd, v, synth, texts, noise_w, noise_z, tol_audio):
    z, y_len, logw, w_ceil = synth.text_to_latent(
        texts, noise_w=noise_w, noise_z=noise_z, with_durations=True)
    wavs = synth.synthesize(texts, noise_w=noise_w, noise_z=noise_z)
    hop = synth.cfg.hop
    assert len(set(int(n) for n in y_len)) > 1        # unequal lengths
    for i, row in enumerate(_row_ids(texts)):
        n, yl = len(row), int(y_len[i])
        want = ref.infer(sd, v, row, noise_w[i], noise_z[i],
                         w_ceil=w_ceil[i, :n], T_y=z.shape[-1])
        assert want["y_len"] == yl
        assert rel(logw[i, :n], want["logw"]) < F32_TOL
        assert rel(z[i, :, :yl], want["z"][:, :yl]) < F32_TOL
        assert wavs[i].dtype == np.float32 and wavs[i].shape == (yl * hop,)
        assert rel(torch.from_numpy(wavs[i]), want["audio"][: yl * hop]) \
            ** 2 < tol_audio
        # the reference's own ceil gives the program's durations here
        own = ref.infer(sd, v, row, noise_w[i], noise_z[i], audio=False)
        assert torch.equal(own["w_ceil"], w_ceil[i, :n])


def test_synthesize_a_batch_of_unequal_lengths(small):
    v, sd, vc, model = small
    texts = inputs.texts(13, 1, 4, SPEC)
    g = torch.Generator().manual_seed(8)
    noise_w = torch.randn(4, 2, 160, generator=g)
    noise_z = torch.randn(4, v["inter_channels"], 1024, generator=g)
    synth = VitsSynthesizer(vc, model)
    _check_rows(sd, v, synth, texts, noise_w, noise_z, F32_TOL ** 2)
    z, y_len = synth.text_to_latent(texts, noise_w=noise_w, noise_z=noise_z)
    b = synth.FRAME_BUCKET
    assert z.shape[-1] % b == 0 and z.shape[-1] - b < int(y_len.max())
    assert z[:, :, int(y_len.max()):].abs().max() == 0


def test_synthesize_seeded_and_checked(small):
    """Drawn noise is a function of the seed; given noise too short for
    the batch raises."""
    _, _, vc, model = small
    synth = VitsSynthesizer(vc, model)
    texts = ["가나다라.", "마바사아자차카."]
    a, b = synth.synthesize(texts, seed=3), synth.synthesize(texts, seed=3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = synth.synthesize(texts, seed=4)
    assert not np.array_equal(a[0], c[0])
    with pytest.raises(ValueError, match="noise_z"):
        synth.synthesize(texts, noise_z=torch.zeros(2, vc.inter_channels, 8))
    with pytest.raises(ValueError, match="noise_w"):
        synth.synthesize(texts, noise_w=torch.zeros(2, 2, 4))


def test_bf16_generator_in_the_synthesizer(small):
    v, sd, vc, _ = small
    model = convert.vits_module_from_torch(sd, vc, "cpu")
    texts = inputs.texts(17, 2, 3, SPEC)
    g = torch.Generator().manual_seed(9)
    noise_w = torch.randn(3, 2, 160, generator=g)
    noise_z = torch.randn(3, v["inter_channels"], 1024, generator=g)
    _check_rows(sd, v, VitsSynthesizer(vc, model), texts, noise_w, noise_z,
                BF16_NSR)


def test_published_widths_on_a_short_text():
    sd = weights_vits.make_weights(CFG, 2 ** 32 + 1, "cpu")
    vc = VitsConfig.from_dict(CFG["vits"])
    assert vc == VitsConfig()                         # ljs_base's widths
    model = f32_module(sd, vc)
    texts = ["안녕.", "가나다라마."]
    g = torch.Generator().manual_seed(10)
    noise_w = torch.randn(2, 2, 64, generator=g)
    noise_z = torch.randn(2, 192, 256, generator=g)
    _check_rows(sd, CFG["vits"], VitsSynthesizer(vc, model), texts,
                noise_w, noise_z, F32_TOL ** 2)


@pytest.mark.parametrize("texts", [["안녕하세요."], ["가.", "나다라 마바사."],
                                   ["Hello, 세계!", ""]])
def test_encode_batch_blanks_and_default(texts):
    ids, lengths = encode_batch(texts)
    seqs = [text_to_sequence(t) for t in texts]
    width = -(-max(len(s) for s in seqs) // 32) * 32
    want = np.full((len(texts), width), PAD_ID, np.int32)
    for i, s in enumerate(seqs):
        want[i, : len(s)] = s
    assert ids.dtype == np.int32 and np.array_equal(ids, want)
    assert lengths.tolist() == [len(s) for s in seqs]
    bids, blens = encode_batch(texts, add_blank=True)
    for i, s in enumerate(seqs):
        assert blens[i] == 2 * len(s) + 1
        assert bids[i, : blens[i]].tolist() == intersperse(s).tolist()
        assert bids[i, 1: blens[i]: 2].tolist() == s.tolist()
        assert (bids[i, 0: blens[i]: 2] == PAD_ID).all()
    assert bids.shape[1] % 32 == 0


def test_cli_writes_a_wav(tmp_path, small):
    """``inference --model vits``: seeded random weights, and an upstream
    checkpoint file, whose WAV equals the library call's."""
    from scipy.io import wavfile

    from text2speech_tpu_torch.dsp.audio import save_wav

    v, sd, vc, _ = small
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({"model": {k: v[k] for k in v}}))
    env = dict(os.environ, PYTHONPATH=ROOT)
    base = [sys.executable, "-m", "text2speech_tpu_torch.inference",
            "--model", "vits", "--device", "cpu", "--vits_config",
            str(cfg_path), "--text", "가나다."]
    out = tmp_path / "random.wav"
    r = subprocess.run(base + ["--random_init", "2", "--out", str(out)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    sr, wav = wavfile.read(out)
    assert sr == 22050 and wav.size > 0 and wav.size % vc.hop == 0
    ckpt = tmp_path / "G_1.pth"
    torch.save({"model": sd, "iteration": 1}, ckpt)
    out = tmp_path / "ckpt.wav"
    r = subprocess.run(base + ["--vits_checkpoint", str(ckpt), "--out",
                               str(out)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    synth = VitsSynthesizer(vc, convert.vits_module_from_torch(sd, vc, "cpu"))
    lib = tmp_path / "lib.wav"
    save_wav(synth.synthesize(["가나다."])[0], str(lib), 22050)
    assert np.array_equal(wavfile.read(out)[1], wavfile.read(lib)[1])
    r = subprocess.run(base + ["--vits_checkpoint", str(ckpt), "--model",
                               "tacotron"], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode != 0 and "--model vits" in r.stderr
