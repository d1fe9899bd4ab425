"""The port's corpus preprocessing (``text2speech_tpu_torch/data/
preprocess.py``, the mu-law family and the silence trim of
``dsp/audio.py``, the CLI ``python -m text2speech_tpu_torch.preprocess``)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.

Tolerances.  The mu-law companding: float32 ``log1p`` of the same values on
both sides (XLA's and the library's last bits), 2e-7 absolute on values in
[-1, 1]; the codes of ``mulaw_quantize`` equal (a code flips only where a
companded value lies within an ulp of a code boundary, which the seeded
inputs here do not meet); ``inv_mulaw`` 1e-6 relative (float32 ``pow``).
The trim bounds: equal, not close (``tests/test_dsp.py:202`` demands the
same of the JAX package's device trim).  ``preprocess_corpus``: the same
``train.txt`` rows, the same ``.npz`` keys and dtypes, the audio equal (the
same host chain; with ``input_type="mulaw"`` within the companding's
2e-7, which moves the last bit of 2% of the samples); mel and linear: both sides sum the same float32 STFT
products (512 terms) in another order, an error of a few ulp of the
frame's largest terms, which in a weak bin is a large share of its own
magnitude (0.03 dB measured): so each value, taken back to a magnitude, is
held within 1e-5 of its frame's largest magnitude (2.2e-6 measured)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from text2speech_tpu.config import HParams as JHParams
from text2speech_tpu.data import preprocess as jpre
from text2speech_tpu.dsp import audio as jaudio
from text2speech_tpu_torch.config import HParams as THParams
from text2speech_tpu_torch.data import preprocess as tpre
from text2speech_tpu_torch.dsp import audio as taudio

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULAW_ATOL = 2e-7
INV_RTOL = 1e-6
FRAME_RTOL = 1e-5
# small hparams for the corpus tests: a fast STFT, the trim on
SMALL = dict(sample_rate=22050, filter_length=512, hop_length=128,
             win_length=512, n_mel_channels=40, mel_fmax=8000.0,
             trim_fft_size=512, trim_hop_size=128)


# --- the mu-law family ------------------------------------------------------


def _signal(seed, n=20000):
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(n) * 0.3, -1, 1).astype(np.float32)
    x[:5] = [-1.0, 1.0, 0.0, 1e-7, -1e-7]
    return x


@pytest.mark.parametrize("mu", [256, 65536])
def test_mulaw_family_matches_jax(mu):
    x = _signal(mu)
    got = taudio.mulaw(torch.from_numpy(x), mu).numpy()
    want = np.array(jaudio.mulaw(jnp.asarray(x), mu))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=MULAW_ATOL, rtol=0)
    q = taudio.mulaw_quantize(torch.from_numpy(x), mu)
    jq = np.asarray(jaudio.mulaw_quantize(jnp.asarray(x), mu))
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), jq)
    assert q.min() >= 0 and q.max() <= mu - 1
    np.testing.assert_allclose(
        taudio.inv_mulaw(torch.from_numpy(want), mu).numpy(),
        np.asarray(jaudio.inv_mulaw(jnp.asarray(want), mu)),
        rtol=INV_RTOL, atol=1e-9)
    np.testing.assert_allclose(
        taudio.inv_mulaw_quantize(q, mu).numpy(),
        np.asarray(jaudio.inv_mulaw_quantize(jnp.asarray(jq), mu)),
        rtol=INV_RTOL, atol=1e-9)


def test_mulaw_quantize_truncates_toward_zero():
    """The codes are the companded value scaled to [0, mu - 1] and cut
    toward zero, as the reference's ``astype(int)``: the cast of the torch
    port does the same for the values it meets (never negative)."""
    x = torch.linspace(-1, 1, 4097)
    y = taudio.mulaw(x, 255)
    scaled = (y + 1) / 2 * 255
    assert scaled.min() >= 0
    np.testing.assert_array_equal(taudio.mulaw_quantize(x, 256).numpy(),
                                  np.floor(scaled.numpy()).astype(np.int32))


def test_start_and_end_indices_match_jax():
    x = _signal(3)
    x[:1000] = 0.0
    x[-2000:] = 0.0
    q = np.asarray(jaudio.mulaw_quantize(jnp.asarray(x), 256))
    for thr in (0, 2, 5):
        assert (taudio.start_and_end_indices(q, thr)
                == jaudio.start_and_end_indices(q, thr))
    silent = np.full(100, 127)
    assert taudio.start_and_end_indices(silent, 2) == (0, 99)


# --- the silence trim -------------------------------------------------------


def _trim_signals():
    """``tests/test_dsp.py:202``'s signals: nine tones with silent lead-ins
    and tails of varied amplitude, and an all-silent row."""
    hp = JHParams()
    rng = np.random.RandomState(0)
    sr = hp.sample_rate
    sigs = []
    for i in range(9):
        lead = rng.randint(0, sr // 2)
        tail = rng.randint(0, sr // 2)
        n = rng.randint(sr // 2, sr)
        t = np.arange(n) / sr
        amp = [0.5, 0.05, 0.9][i % 3]
        tone = amp * np.sin(2 * np.pi * (150 + 60 * i) * t)
        sigs.append(np.concatenate([np.zeros(lead, np.float32),
                                    tone.astype(np.float32),
                                    np.zeros(tail, np.float32)]))
    sigs.append(np.zeros(sr // 3, np.float32))
    return hp, sigs


def test_trim_bounds_equal_jax_host_and_device():
    """Host bounds equal the JAX package's host bounds; the port's batched
    bounds equal both, row by row, the all-silent row included."""
    hp, sigs = _trim_signals()
    args = (hp.trim_top_db, hp.trim_fft_size, hp.trim_hop_size)
    host = [jaudio.trim_silence_bounds(y, *args) for y in sigs]
    assert [taudio.trim_silence_bounds(y, *args) for y in sigs] == host
    T = max(len(y) for y in sigs)
    batch = np.zeros((len(sigs), T), np.float32)
    lens = np.array([len(y) for y in sigs], np.int32)
    for j, y in enumerate(sigs):
        batch[j, :len(y)] = y
    starts, ends = taudio.trim_bounds_batch(
        torch.from_numpy(batch), torch.from_numpy(lens), *args)
    assert starts.dtype == ends.dtype == torch.int32
    js, je = jax.jit(lambda y, n: jaudio.trim_bounds_batch(y, n, *args))(
        jnp.asarray(batch), jnp.asarray(lens))
    assert list(zip(starts.tolist(), ends.tolist())) == host
    assert starts.tolist() == np.asarray(js).tolist()
    assert ends.tolist() == np.asarray(je).tolist()
    assert host[-1] == (0, len(sigs[-1]))        # all silent: all "loud"


def test_trim_silence_matches_jax():
    hp, sigs = _trim_signals()
    thp = THParams()
    for y in sigs[:3]:
        np.testing.assert_array_equal(taudio.trim_silence(y, thp),
                                      jaudio.trim_silence(y, hp))


def test_choose_trim_impl_policy():
    """``tests/test_dsp.py:302``'s cases: a multi-GB/s link makes the
    upload nearly free (device), a slow one makes it dearer than the numpy
    trim (host), a slow host CPU flips it back (device)."""
    avg = 3.0 * 22050
    for args, want in (((8000.0, 30e6, avg), "device"),
                       ((21.0, 30e6, avg), "host"),
                       ((200.0, 1e6, avg), "device")):
        assert tpre.choose_trim_impl(*args) == want
        assert jpre.choose_trim_impl(*args) == want


def test_probe_trim_costs_on_the_cpu():
    """No copy to a CPU device: an infinite rate, so ``auto`` places the
    trim on the device; the host rate is measured and cached."""
    hp = THParams(**SMALL)
    h2d, host_sps = tpre.probe_trim_costs(hp, "cpu")
    assert h2d == float("inf") and host_sps > 0
    assert tpre.probe_trim_costs(hp, "cpu") == (h2d, host_sps)
    assert tpre.choose_trim_impl(h2d, host_sps, 66150) == "device"


# --- preprocess_corpus against the JAX package's ----------------------------


def _write_corpus(root, seed=0):
    """A KSS-shaped corpus: wavs at 44,100 Hz with silent lead-ins and
    tails under ``1/``, and a transcript whose fourth row has two text
    columns that differ in word count (two items of one wav).  The fifth
    wav is the first one's utterance behind a lead-in shorter by ten hops
    at 22,050 Hz: the same trimmed length from a shorter file, so that the
    length sort meets a tie whose order the trim placements must agree on
    (the device trim visits the files by their untrimmed length)."""
    (root / "1").mkdir(parents=True)
    rng = np.random.RandomState(seed)
    texts = [("안녕하세요.", "안녕하세요."), ("오늘 날씨가 좋다.", "오늘 날씨가 좋다."),
             ("존경하는 사람.", "존경하는 사람."),
             ("이 것은 제작되고 있는 중입니다.", "이것은 제작 중입니다.")]
    lines = []
    for i, (a, b) in enumerate(texts):
        n = 44100 // 3 + i * 5000
        t = np.arange(n) / 44100.0
        sig = np.concatenate([
            np.zeros(4560 if i == 0 else 2000 + 700 * i, np.float32),
            (0.4 * np.sin(2 * np.pi * (180 + 45 * i) * t)
             + 0.01 * rng.randn(n)).astype(np.float32),
            np.zeros(3000, np.float32)])
        wavfile.write(str(root / "1" / f"1_{i:04d}.wav"), 44100,
                      (sig * 32767).astype(np.int16))
        lines.append(f"1/1_{i:04d}.wav|{a}|{b}|{1.0 + i}초")
        if i == 0:
            first = sig
    wavfile.write(str(root / "1" / "1_0004.wav"), 44100,
                  (first[2560:] * 32767).astype(np.int16))
    lines.append("1/1_0004.wav|반갑습니다.|반갑습니다.|1.1초")
    (root / "transcript.txt").write_text("\n".join(lines) + "\n",
                                         encoding="utf-8")
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("kss"))


@pytest.fixture(scope="module")
def outputs(corpus, tmp_path_factory):
    """Each input_type through both packages (the port's device trim), and
    raw through the port's host trim: {name: (out_dir, metadata)}."""
    res = {}
    for it in ("raw", "mulaw", "mulaw-quantize"):
        jhp, thp = JHParams(**SMALL, input_type=it), THParams(**SMALL,
                                                               input_type=it)
        d = str(tmp_path_factory.mktemp(f"jax_{it}"))
        res[f"jax {it}"] = (d, jpre.preprocess_corpus(
            jhp, corpus, d, num_workers=2, device_batch=2,
            trim_impl="host"))
        d = str(tmp_path_factory.mktemp(f"torch_{it}"))
        res[f"torch {it}"] = (d, tpre.preprocess_corpus(
            thp, corpus, d, num_workers=2, device_batch=2,
            trim_impl="device", device="cpu"))
    d = str(tmp_path_factory.mktemp("torch_raw_host"))
    res["torch raw host"] = (d, tpre.preprocess_corpus(
        THParams(**SMALL), corpus, d, num_workers=2, device_batch=3,
        trim_impl="host", device="cpu"))
    return res


def _db_close(got, want):
    """dB spectrograms [frames, bins] (``amp_to_db(.) - ref_level_db``)
    within FRAME_RTOL of each frame's largest magnitude."""
    assert got.shape == want.shape and got.dtype == want.dtype
    ag, aw = 10.0 ** ((got + 20.0) / 20.0), 10.0 ** ((want + 20.0) / 20.0)
    assert (np.abs(ag - aw) <= FRAME_RTOL * aw.max(1, keepdims=True)).all()


@pytest.mark.parametrize("input_type", ["raw", "mulaw", "mulaw-quantize"])
def test_preprocess_corpus_matches_jax(outputs, input_type):
    jd, jmeta = outputs[f"jax {input_type}"]
    td, tmeta = outputs[f"torch {input_type}"]
    assert tmeta == jmeta and len(tmeta) == 6
    # the tie: equal lengths, transcript order
    assert [m[6] for m in tmeta if m[4] == tmeta[0][4]][:2] == [
        "1_0000.npz", "1_0004.npz"]
    # the duplicate row: two items of one wav, two npz files
    names = [m[6] for m in tmeta]
    assert "1_0003.npz" in names and "1_0003-2.npz" in names
    for m in tmeta:
        with np.load(os.path.join(jd, m[6])) as j, \
                np.load(os.path.join(td, m[6])) as t:
            assert sorted(t.files) == sorted(j.files) == sorted(
                ["audio", "mel", "linear", "time_steps", "mel_frames",
                 "text", "tokens", "loss_coeff"])
            for k in t.files:
                assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
            if input_type == "mulaw":     # the companding's last bits
                np.testing.assert_allclose(t["audio"], j["audio"],
                                           atol=MULAW_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(t["audio"], j["audio"])
            for k in ("time_steps", "mel_frames", "text", "tokens",
                      "loss_coeff"):
                np.testing.assert_array_equal(t[k], j[k])
            _db_close(t["mel"], j["mel"])
            _db_close(t["linear"], j["linear"])
    want_dtype = np.int16 if input_type == "mulaw-quantize" else np.float32
    with np.load(os.path.join(td, names[0])) as t:
        assert t["audio"].dtype == want_dtype


def test_device_trim_equals_host_trim(outputs):
    """The port's two trim placements write equal arrays and rows."""
    dd, dmeta = outputs["torch raw"]
    hd, hmeta = outputs["torch raw host"]
    assert dmeta == hmeta
    for m in dmeta:
        with np.load(os.path.join(dd, m[6])) as a, \
                np.load(os.path.join(hd, m[6])) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_write_metadata_rows_equal_jax(outputs, tmp_path):
    _, jmeta = outputs["jax raw"]
    _, tmeta = outputs["torch raw"]
    jpre.write_metadata(jmeta, str(tmp_path), JHParams(**SMALL))
    want = (tmp_path / "train.txt").read_text(encoding="utf-8")
    tpre.write_metadata(tmeta, str(tmp_path), THParams(**SMALL))
    assert (tmp_path / "train.txt").read_text(encoding="utf-8") == want
    assert len(want.splitlines()) == 6


def test_datasets_read_either_packages_output(outputs):
    """The port's npz feeder (the Tacotron trainer's reader of preprocess
    output) batches the JAX package's output and the JAX feeder the
    port's: the same mels and texts either way."""
    from text2speech_tpu.data.npz_dataset import NpzDataFeeder as JFeeder
    from text2speech_tpu_torch.data.npz_dataset import (NpzDataFeeder as
                                                        TFeeder)

    jd, _ = outputs["jax raw"]
    td, _ = outputs["torch raw"]
    hp = THParams(**SMALL, batch_size=2)
    t_on_j = TFeeder([jd], hp, min_n_frame=1, device="cpu")
    j_on_t = JFeeder([td], JHParams(**SMALL, batch_size=2), min_n_frame=1)
    t_on_t = TFeeder([td], hp, min_n_frame=1, device="cpu")
    assert len(t_on_j.corpus_files[0]) == len(t_on_t.corpus_files[0]) == 6
    a = t_on_j.sample_batch()
    b = t_on_t.sample_batch()
    c = j_on_t.sample_batch()
    assert a.mel.shape == b.mel.shape and a.mel.shape[1] == 40
    np.testing.assert_array_equal(a.text.numpy(), b.text.numpy())
    _db_close(a.mel.numpy()[0].T, b.mel.numpy()[0].T)
    np.testing.assert_array_equal(np.asarray(c.mel), b.mel.numpy())
    np.testing.assert_array_equal(np.asarray(c.text), b.text.numpy())


def test_cli_writes_the_contract_on_the_cpu(corpus, tmp_path, outputs):
    """``python -m text2speech_tpu_torch.preprocess --device cpu`` writes
    what ``preprocess_corpus`` writes, and ``train.txt``; with ``--device
    cuda`` and no GPU it raises."""
    import json

    hp_path = tmp_path / "hp.json"
    hp_path.write_text(json.dumps(SMALL))
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "text2speech_tpu_torch.preprocess",
         "--in_dir", corpus, "--out_dir", str(out), "--hparams",
         str(hp_path), "--num_workers", "2", "--device_batch", "2",
         "--trim_impl", "host", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "mel frames/sec" in r.stdout
    rows = (out / "train.txt").read_text(encoding="utf-8").splitlines()
    _, tmeta = outputs["torch raw"]
    assert rows == ["|".join(str(x) for x in m) for m in tmeta]
    td, _ = outputs["torch raw"]
    for m in tmeta:
        with np.load(out / m[6]) as a, np.load(os.path.join(td, m[6])) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    from text2speech_tpu_torch import preprocess as cli

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            cli.main(["--in_dir", corpus, "--out_dir", str(tmp_path / "x")])


def test_cli_flags_are_the_root_scripts():
    """Every option of root ``preprocess.py`` is an option of the port's
    CLI, which adds ``--device``."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "preprocess.py")).read())
    root = {a.value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args[:1] if isinstance(a, ast.Constant)}
    from text2speech_tpu_torch import preprocess as cli

    port = {o for a in cli.build_parser()._actions for o in a.option_strings}
    assert root and root <= port
    assert port - root == {"--device", "-h", "--help"}


def test_transcript_parser_dispatch(corpus):
    rows = tpre.get_transcript_parser("kss")(corpus)
    assert rows == jpre.parse_transcript(corpus) and len(rows) == 6
    tpre.register_transcript_parser("mine", lambda d: rows[:1])
    assert tpre.get_transcript_parser("mine")(corpus) == rows[:1]
    with pytest.raises(ValueError, match="unknown dataset"):
        tpre.get_transcript_parser("no_such_corpus_module")
