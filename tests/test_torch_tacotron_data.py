"""Tacotron training around the step: the data (``TextMelDataset``,
``NpzDataFeeder``) against the JAX package's batches on a tiny synthetic
corpus, the trainer and its CLI on the CPU (checkpoints, resume, warm
start, interrupt, the empty-dataset error, validation), the weight bridge
both ways, and what waited on Tacotron training: ``Synthesizer.
load_checkpoints(taco_ckpt_dir=)``, ``POST /reload {"taco_ckpt_dir"}``,
``load_synthesizer`` from two checkpoint directories and the inference
CLI's ``--taco_checkpoint`` / ``--waveglow_checkpoint``.

Tolerances: text, lengths, gates, speaker ids and the epoch order are
integers and must be equal; the mels are the same f32 STFT matmuls in
another order, 1e-4 on log-mels of order 1 to 10.  A resumed run repeats
the uninterrupted run's operations on the CPU: bit-equal."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.data.dataset import TextMelDataset as JaxDataset
from text2speech_tpu.data.npz_dataset import NpzDataFeeder as JaxFeeder
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert, inference, tacotron_train
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.data.dataset import TextMelDataset
from text2speech_tpu_torch.data.npz_dataset import NpzDataFeeder
from text2speech_tpu_torch.infer import (load_synthesizer,
                                         random_synthesizer)
from text2speech_tpu_torch.models.tacotron2 import Tacotron2, init_weights_
from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
from text2speech_tpu_torch.server import make_server
from text2speech_tpu_torch.train.checkpoint import CheckpointManager
from text2speech_tpu_torch.train.state import (create_train_state,
                                               create_tacotron_state)
from text2speech_tpu_torch.train.tacotron import TacotronTrainer

from tests.test_torch_http_serve import post, serve, stop

torch.set_num_threads(1)

TINY = dict(
    sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, batch_size=2,
    max_decoder_steps=44,
)
HP, JHP = HParams(**TINY), JaxHParams(**TINY)
WG = WaveGlowConfig(
    n_mel_channels=8, n_flows=2, n_group=8, n_early_every=4, n_early_size=2,
    wn_n_layers=2, wn_n_channels=16, upsample_kernel=64, upsample_stride=16,
    sampling_rate=22050, hop_length=16)
TEXTS = ["안녕하세요.", "존경하는 사람과 함께 갑니다.", "네.",
         "오늘 날씨가 참 좋네요.", "만나서 반갑습니다.", "고맙습니다."]


def write_corpus(root, n=6, seed=0) -> str:
    """``n`` short wavs (tones in noise, 0.2-0.45 s at 22.05 kHz) and a
    KSS-style ``transcript.txt``."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "1"), exist_ok=True)
    lines = []
    for i in range(n):
        t = np.arange(4410 + 1100 * i) / 22050.0
        y = 0.3 * np.sin(2 * np.pi * (220 + 40 * i) * t) \
            + 0.05 * rng.randn(t.size)
        name = f"1/{i:02d}.wav"
        wavfile.write(os.path.join(root, name), 22050,
                      (np.clip(y, -1, 1) * 32767).astype(np.int16))
        lines.append(f"{name}|{TEXTS[i % len(TEXTS)]}|x|1.0")
    with open(os.path.join(root, "transcript.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(root)


def _assert_batches_equal(got, want):
    g = got.numpy()
    for name in ("text", "input_lengths", "gate", "speaker_id",
                 "output_lengths"):
        np.testing.assert_array_equal(getattr(g, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(g.mel, np.asarray(want.mel), atol=1e-4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("kss"))


def test_text_mel_batches_equal_jax(corpus):
    ours = TextMelDataset([corpus], HP)
    theirs = JaxDataset([corpus], JHP)
    assert len(ours) == len(theirs) == 3
    for epoch, start in ((0, 0), (1, 1)):
        got = list(ours.epoch(epoch, start))
        want = list(theirs.epoch(epoch, start))
        assert len(got) == len(want) == 3 - start
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
    # padded frames are zero, the gate is 1 from the last frame on
    b = got[0]
    n = int(b.output_lengths[-1])
    assert not b.mel[-1, :, n:].any() and b.gate[-1, n - 1:].eq(1).all()
    held = ours.hold_out_per_speaker(1)
    jheld = theirs.hold_out_per_speaker(1)
    assert held.items == jheld.items and ours.items == theirs.items


def test_npz_batches_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    for c in range(2):
        d = tmp_path / f"c{c}"
        d.mkdir()
        for i in range(5):
            frames = 9 + 7 * i + c
            np.savez(d / f"u{i}.npz", tokens=rng.randint(1, 70, 5 + i),
                     mel=rng.randn(frames, 8).astype(np.float32),
                     mel_frames=frames)
    dirs = [str(tmp_path / "c0"), str(tmp_path / "c1")]
    ours = NpzDataFeeder(dirs, HP, initial_phase_step=1)
    theirs = JaxFeeder(dirs, JHP, initial_phase_step=1)
    assert len(ours) == len(theirs) == 5
    for start in (0, 3):
        for g, w in zip(ours.epoch(2, start), theirs.epoch(2, start)):
            _assert_batches_equal(g, w)
    _assert_batches_equal(ours.sample_batch(), theirs.sample_batch())


def _cli(corpus, tmp_path, *extra):
    tmp_path.mkdir(parents=True, exist_ok=True)
    hp_path = tmp_path / "tiny.json"
    HP.save(str(hp_path))
    return tacotron_train.main([
        "--data_paths", corpus, "--log_dir", str(tmp_path / "logs"),
        "--hparams", str(hp_path), "--checkpoint_interval", "1",
        "--device", "cpu", *extra])


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.state.params.items()}


def test_cli_trains_resumes_and_validates(corpus, tmp_path):
    """Two steps, then a resume to three in a run of its own that reloads
    the run's hparams: bit-equal to three steps in one run (the data order
    is a function of the epoch, the masks of the step).  With one
    utterance held out per speaker there are 2 batches an epoch, so step 3
    crosses into epoch 1."""
    straight = _cli(corpus, tmp_path / "a", "--num_steps", "3")
    assert straight.state.step == 3 and len(straight.dataset) == 2
    assert straight.valset is not None
    assert np.isfinite(straight.validate(3))
    first = _cli(corpus, tmp_path / "b", "--num_steps", "2")
    run_dir = first.run_dir
    ckpt = os.path.join(run_dir, "checkpoints")
    assert CheckpointManager(ckpt).all_steps() == [1, 2]
    assert os.path.exists(os.path.join(run_dir, "train.log"))
    resumed = tacotron_train.main([
        "--data_paths", corpus, "--load_path", run_dir, "--num_steps", "3",
        "--checkpoint_interval", "1", "--device", "cpu"])
    assert resumed.state.step == 3
    want, got = _params(straight), _params(resumed)
    for name, p in want.items():
        assert torch.equal(got[name], p), name
    for name, b in straight.state.batch_stats.items():
        assert torch.equal(resumed.state.batch_stats[name], b), name
    assert float(resumed.last_metrics["loss"]) == pytest.approx(
        float(straight.last_metrics["loss"]), rel=1e-6)


def test_cli_variants_and_warm_start(corpus, tmp_path):
    """``--remat``, ``--grad_accum 2`` and ``--bf16`` take a step each;
    ``--checkpoint_file`` warm-starts a new run from another's step."""
    base = _cli(corpus, tmp_path / "a", "--num_steps", "1")
    ckpt = os.path.join(base.run_dir, "checkpoints")
    for flags in (["--remat"], ["--grad_accum", "2"], ["--bf16"]):
        t = _cli(corpus, tmp_path / flags[0].strip("-"), "--num_steps", "2",
                 "--checkpoint_file", ckpt, *flags)
        assert t.state.step == 2
        assert np.isfinite(float(t.last_metrics["loss"])), flags
    assert t.model.compute_dtype == torch.bfloat16


def test_trainer_checkpoints_on_interrupt_and_refuses_empty_data(
        corpus, tmp_path):
    trainer = TacotronTrainer(HP, [corpus], str(tmp_path / "run"),
                              device="cpu")
    step = trainer._train_step
    calls = []

    def interrupted(state, batch, gen):
        if calls:
            raise KeyboardInterrupt
        calls.append(1)
        return step(state, batch, gen)

    trainer._train_step = interrupted
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(5)
    assert trainer.ckpt.all_steps() == [1]
    big = TacotronTrainer(HP.replace(batch_size=64), [corpus],
                          str(tmp_path / "big"), device="cpu")
    with pytest.raises(ValueError, match="0 batches"):
        big.fit(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            tacotron_train.main(["--data_paths", corpus])


def test_trainer_reads_npz_corpora(tmp_path):
    d = tmp_path / "npz"
    d.mkdir()
    rng = np.random.RandomState(4)
    for i in range(4):
        np.savez(d / f"u{i}.npz", tokens=rng.randint(1, 70, 6),
                 mel=rng.randn(20 + i, 8).astype(np.float32), mel_frames=20)
    trainer = TacotronTrainer(HP, [str(d)], str(tmp_path / "run"),
                              device="cpu")
    assert isinstance(trainer.dataset, NpzDataFeeder)
    trainer.fit(1)
    assert trainer.state.step == 1


def test_weights_both_ways():
    """JAX variables -> a trainable port model -> flat flax variables: the
    same arrays; a port model's variables load through ``load_tacotron``
    unchanged."""
    import jax

    rng = jax.random.PRNGKey(0)
    jmodel = JaxTacotron2(JHP, n_vocab=N_SYMBOLS, num_speakers=2)
    text = jnp.ones((2, 8), jnp.int32)
    variables = jax.jit(jmodel.init)(
        {"params": rng, "dropout": rng}, text, jnp.asarray([8, 5]),
        jnp.zeros((2, 8, 8)), jnp.asarray([8, 6]),
        speaker_ids=jnp.asarray([0, 1]))
    flat = convert.flatten_tree(variables)
    model = convert.trainable_tacotron_from_variables(variables, HP,
                                                      N_SYMBOLS, 2)
    back = convert.variables_from_tacotron(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    ours = init_weights_(Tacotron2(HP, N_SYMBOLS, 2),
                         torch.Generator().manual_seed(0))
    loaded = convert.load_tacotron(convert.variables_from_tacotron(ours), HP,
                                   N_SYMBOLS, 2)
    for k, v in ours.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _taco_checkpoint(path) -> Tacotron2:
    """A Tacotron training checkpoint of the tiny model at step 5 (random
    weights, moved running statistics) -> the model saved."""
    model = init_weights_(Tacotron2(HP, N_SYMBOLS, 1),
                          torch.Generator().manual_seed(7))
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_var"):
                m.running_var.fill_(2.0)
    state = create_tacotron_state(model, HP)
    state.step = 5
    CheckpointManager(str(path)).save(5, state)
    return model


def _same_taco(a: Tacotron2, b: Tacotron2) -> bool:
    sb = b.state_dict()
    return all(torch.equal(v, sb[k]) for k, v in a.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def test_synthesizer_load_checkpoints_and_reload_take_taco_ckpt_dir(
        tmp_path):
    saved = _taco_checkpoint(tmp_path / "taco")
    syn = random_synthesizer(HP, WG, seed=0, device="cpu",
                             use_fused_vocoder=False, use_denoiser=False)
    assert not _same_taco(syn.taco, saved)
    syn.load_checkpoints(taco_ckpt_dir=str(tmp_path / "taco"))
    assert _same_taco(syn.taco, saved)
    mel, lengths = syn.text_to_mel([TEXTS[0]], max_steps=8)
    assert torch.isfinite(mel).all()
    with pytest.raises(ValueError, match="not both"):
        syn.load_checkpoints(taco_ckpt_dir="a", taco_npz="b")

    other = random_synthesizer(HP, WG, seed=1, device="cpu",
                               use_fused_vocoder=False, use_denoiser=False)
    served = serve(make_server(other, slots=2, chunk_steps=8,
                               max_text_len=80),
                   reload_fn=other.load_checkpoints)
    try:
        port = served[0].server_address[1]
        resp, body = post(port, {"taco_ckpt_dir": str(tmp_path / "taco")},
                          "/reload")
        assert resp.status == 200 and json.loads(body) == {"ok": True}
        assert _same_taco(other.taco, saved)
        resp, _ = post(port, {"taco_ckpt_dir": str(tmp_path / "none")},
                       "/reload")
        assert resp.status == 400                # no checkpoint there
    finally:
        stop(*served)


def test_load_synthesizer_from_two_checkpoint_directories(tmp_path):
    saved = _taco_checkpoint(tmp_path / "taco")
    wg = TrainableWaveGlow(WG, generator=torch.Generator().manual_seed(3))
    wstate = create_train_state(wg.params, 1e-4)
    CheckpointManager(str(tmp_path / "wg")).save(2, wstate)
    syn = load_synthesizer(HP, None, WG, use_denoiser=False, device="cpu",
                           taco_ckpt_dir=str(tmp_path / "taco"),
                           wg_ckpt_dir=str(tmp_path / "wg"))
    assert _same_taco(syn.taco, saved)
    want = convert.load_waveglow(convert.variables_from_trainable(wg), WG)
    for k, v in want.state_dict().items():
        assert torch.equal(syn.waveglow.state_dict()[k], v), k
    (audio,) = syn.synthesize([TEXTS[2]], max_steps=6)
    assert np.isfinite(audio).all() and audio.size > 0
    with pytest.raises(ValueError, match="taco_ckpt_dir and wg_ckpt_dir"):
        load_synthesizer(HP, None, WG, device="cpu",
                         taco_ckpt_dir=str(tmp_path / "taco"))


def test_inference_cli_takes_checkpoint_directories(tmp_path):
    args = inference.build_parser().parse_args(
        ["--taco_checkpoint", "t", "--waveglow_checkpoint", "w"])
    assert (args.taco_checkpoint, args.waveglow_checkpoint) == ("t", "w")
    with pytest.raises(SystemExit):     # a vocoder needs its Tacotron
        inference.main(["--random_init", "0", "--waveglow_checkpoint", "w"])
    with pytest.raises(SystemExit):     # one source of weights at a time
        inference.build_parser().parse_args(
            ["--taco_checkpoint", "t", "--random_init", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            inference.main(["--taco_checkpoint", "t",
                            "--waveglow_checkpoint", "w"])
        # a Tacotron checkpoint alone takes the Griffin-Lim path, on the
        # card as well
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            inference.main(["--taco_checkpoint", "t"])
