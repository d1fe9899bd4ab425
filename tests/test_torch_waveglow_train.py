"""WaveGlow training in the port (``TrainableWaveGlow``, ``waveglow_loss``,
``make_wg_train_step``, checkpoints, the CLI) against the JAX package's on
the same numpy inputs and converted weights.

Config: the tiny one of ``tests/test_train_infra.py`` widened to 4 flows
of groups of 8 with one early output (2 WN layers, C=16, segment 512), so
that every flow's coupling half is at least 3 wide: with one input channel
a weight-normed ``start`` conv's ``v`` has an exactly zero gradient.  JAX
initialises the parameters; every leaf is then perturbed by 0.01 N(0, 1),
so the zero-init ``end`` convs are live and no gradient leaf is zero (Adam
turns a gradient near zero into a step of a full ``lr`` in either
direction).  On the CPU the port's gated activation takes its plain
version and the JAX package's its reference expression.

Tolerances.  f32: both sides do the same f32 products and sums in another
order through 4 flows; forward 1e-5 absolute on values of unit scale, each
gradient leaf 2e-5 of the leaf's largest entry.  The loss is a difference
of per-element terms of about 1e-2 that nearly cancel here, so it is held
to 1e-7 absolute (1e-5 of its terms), not relative to itself.  After
optimizer steps parameters are compared in units of ``lr``: Adam's update
is ``lr * m / (sqrt(v) + eps)``, of size ``lr`` whatever the gradient's,
and a relative gradient difference of 1e-5 moves it by about that share of
``lr``; the bound is 0.02 ``lr`` over three steps.  bf16: products of
bf16-rounded operands (2^-8 relative each) through 2 layers and 4 flows,
and the JAX reference expression does its bf16 tanh and sigmoid in bf16
where the port's kernel arithmetic is f32: loss within 1e-3 absolute, each
gradient leaf within 8% of its norm (the worst leaf, a bias of 16 entries,
measures 5%)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp
import optax

from text2speech_tpu.config import WaveGlowConfig as JaxConfig
from text2speech_tpu.data.mel2samp import VocoderBatch as JaxBatch
from text2speech_tpu.models.losses import waveglow_loss as jax_loss
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.train.state import TrainState as JaxTrainState
from text2speech_tpu.train.waveglow import \
    make_wg_train_step as jax_make_step
from text2speech_tpu_torch import convert, waveglow_train
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.data.mel2samp import VocoderBatch
from text2speech_tpu_torch.models.losses import waveglow_loss
from text2speech_tpu_torch.models.waveglow import (TrainableWaveGlow,
                                                   flow_widths)
from text2speech_tpu_torch.ops.gated import gated_plain
from text2speech_tpu_torch.train.checkpoint import CheckpointManager
from text2speech_tpu_torch.train.state import (create_train_state,
                                               global_norm, microbatch_split)
from text2speech_tpu_torch.train.waveglow import (WaveGlowTrainer,
                                                  make_wg_train_step)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2, n_early_size=2,
    wn_n_layers=2, wn_n_channels=16, upsample_kernel=32, upsample_stride=8,
    segment_length=512, learning_rate=1e-3, sigma=0.9,
)
CFG, JCFG = WaveGlowConfig(**TINY), JaxConfig(**TINY)
B = 4
LR = TINY["learning_rate"]
LOSS_ATOL = 1e-7


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    frames = CFG.segment_length // CFG.upsample_stride
    mel = rng.randn(B, CFG.n_mel_channels, frames).astype(np.float32)
    audio = (0.1 * rng.randn(B, CFG.segment_length)).astype(np.float32)
    variables = JaxWaveGlow(JCFG).init(
        jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(audio))
    prng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * prng.randn(*x.shape).astype(
            np.float32), variables["params"])
    return params, mel, audio


def _port(params, **kw) -> TrainableWaveGlow:
    return convert.trainable_waveglow_from_variables({"params": params}, CFG,
                                                     **kw)


def _flat(tree, leaf=np.asarray) -> dict:
    """A flax tree as {'/'-joined path: leaf(value)}."""
    return {"/".join(str(k.key) for k in path): leaf(value)
            for path, value in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_loss_fn(model):
    def loss_fn(p, mel, audio):
        z, log_s, log_det = model.apply({"params": p}, mel, audio)
        return jax_loss(z.transpose(0, 2, 1), log_s, log_det, CFG.sigma)
    return loss_fn


def test_forward_matches_jax(setup):
    params, mel, audio = setup
    z, log_s, log_det = JaxWaveGlow(JCFG).apply(
        {"params": params}, jnp.asarray(mel), jnp.asarray(audio))
    with torch.no_grad():
        tz, tlog_s, tlog_det = _port(params)(torch.from_numpy(mel),
                                             torch.from_numpy(audio))
    assert tz.shape == (B, CFG.segment_length // CFG.n_group, CFG.n_group)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-5)
    np.testing.assert_allclose(float(tlog_s), float(log_s), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(float(tlog_det), float(log_det), rtol=1e-5,
                               atol=1e-4)
    got = waveglow_loss(tz, tlog_s, tlog_det, CFG.sigma)
    want = jax_loss(z.transpose(0, 2, 1), log_s, log_det, CFG.sigma)
    assert float(got) == pytest.approx(float(want), abs=LOSS_ATOL)


def test_forward_cuts_the_mel_to_the_audio(setup):
    """More mel frames than the audio covers: the upsampled mel is cut to
    the audio's length, as the JAX forward cuts it."""
    params, mel, audio = setup
    long_mel = np.concatenate([mel, mel[:, :, :5]], axis=2)
    z = JaxWaveGlow(JCFG).apply({"params": params}, jnp.asarray(long_mel),
                                jnp.asarray(audio))[0]
    with torch.no_grad():
        tz = _port(params)(torch.from_numpy(long_mel),
                           torch.from_numpy(audio))[0]
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(setup, dtype):
    params, mel, audio = setup
    jmodel = JaxWaveGlow(JCFG, compute_dtype=getattr(jnp, dtype))
    want_loss, want = jax.value_and_grad(_jax_loss_fn(jmodel))(
        params, jnp.asarray(mel), jnp.asarray(audio))
    want = _flat(want)
    model = _port(params, compute_dtype=getattr(torch, dtype))
    z, log_s, log_det = model(torch.from_numpy(mel), torch.from_numpy(audio))
    loss = waveglow_loss(z, log_s, log_det, CFG.sigma)
    loss.backward()
    assert loss.dtype == torch.float32
    loss = loss.detach()
    assert set(want) == set(model.params.keys())
    if dtype == "float32":
        assert float(loss) == pytest.approx(float(want_loss), abs=LOSS_ATOL)
    else:
        assert float(loss) == pytest.approx(float(want_loss), abs=1e-3)
    for name, p in model.params.items():
        assert p.grad.dtype == torch.float32 and p.grad.shape == p.shape
        got, ref = p.grad.numpy(), want[name]
        assert np.abs(ref).max() > 0, name
        if dtype == "float32":
            np.testing.assert_allclose(
                got, ref, atol=2e-5 * np.abs(ref).max(), err_msg=name)
        else:
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel < 0.08, (name, rel)


def test_three_train_steps_track_jax(setup):
    params, mel, audio = setup
    tx = optax.adam(LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats={}, opt_state=tx.init(params), tx=tx)
    jstep = jax.jit(jax_make_step(JaxWaveGlow(JCFG), CFG.sigma))
    model = _port(params)
    state = create_train_state(model.params, LR)
    step = make_wg_train_step(model, CFG.sigma)
    rng = np.random.RandomState(5)
    for i in range(3):
        m = mel + 0.1 * rng.randn(*mel.shape).astype(np.float32)
        a = audio + 0.01 * rng.randn(*audio.shape).astype(np.float32)
        jstate, jm = jstep(jstate, JaxBatch(jnp.asarray(m), jnp.asarray(a)))
        state, tm = step(state, VocoderBatch(torch.from_numpy(m),
                                             torch.from_numpy(a)))
        assert state.step == i + 1 == int(jstate.step)
        # from the second step on the two sides' parameters differ by
        # fractions of lr: ten times the single-evaluation bound
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  abs=10 * LOSS_ATOL)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    want = _flat(jstate.params)
    for name, p in model.params.items():
        diff = np.abs(p.detach().numpy() - want[name]).max()
        assert diff < 0.02 * LR, (name, diff / LR)
    # and they did move: three steps of about lr each
    moved = max(np.abs(p.detach().numpy() - _flat(params)[n]).max()
                for n, p in model.params.items())
    assert moved > 2 * LR


def _one_step(params, mel, audio, grad_accum=1, **kw):
    model = _port(params, **kw)
    state = create_train_state(model.params, LR)
    step = make_wg_train_step(model, CFG.sigma, grad_accum=grad_accum)
    _, metrics = step(state, VocoderBatch(torch.from_numpy(mel),
                                          torch.from_numpy(audio)))
    return model, metrics


def test_grad_accum_matches_full_batch(setup):
    """The accumulated step is the full-batch step: same loss, same updated
    parameters (the JAX package's own bounds, ``tests/test_train_infra.py``:
    1e-6 relative and absolute)."""
    params, mel, audio = setup
    full, m1 = _one_step(params, mel, audio)
    acc, m2 = _one_step(params, mel, audio, grad_accum=2)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-5)
    for name, p in full.params.items():
        assert (p - acc.params[name]).abs().max() < 1e-6, name
    with pytest.raises(ValueError, match="not divisible"):
        _one_step(params, mel, audio, grad_accum=3)


def test_microbatch_split_is_strided():
    x = torch.arange(6).reshape(6, 1)
    got = microbatch_split(x, 3)
    assert got.shape == (3, 2, 1)
    assert got[1, :, 0].tolist() == [1, 4]
    assert float(global_norm([torch.tensor([3.0]), torch.tensor([4.0])])) == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_equals_plain(setup, dtype):
    """Recomputing each flow's WN in the backward pass replays the same
    operations on the same values: bit-equal loss and gradients."""
    params, mel, audio = setup
    grads = []
    for remat in (False, True):
        model = _port(params, remat=remat,
                      compute_dtype=getattr(torch, dtype))
        z, log_s, log_det = model(torch.from_numpy(mel),
                                  torch.from_numpy(audio))
        loss = waveglow_loss(z, log_s, log_det, CFG.sigma)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      model.params.items()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


def test_plain_gated_argument_equals_the_default(setup):
    """``gated=gated_plain`` (the run a card's kernels are held against)
    differentiates the same expression through autograd."""
    params, mel, audio = setup
    a, ma = _one_step(params, mel, audio)
    b, mb = _one_step(params, mel, audio, gated=gated_plain)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)
    assert float(ma["grad_norm"]) == pytest.approx(float(mb["grad_norm"]),
                                                   rel=1e-5)


def test_init_properties():
    gen = torch.Generator().manual_seed(3)
    model = TrainableWaveGlow(CFG, generator=gen)
    p = model.params
    jshapes = jax.eval_shape(
        JaxWaveGlow(JCFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8, 64)), jnp.zeros((1, 512)))["params"]
    assert ({n: tuple(v.shape) for n, v in p.items()}
            == _flat(jshapes, leaf=lambda v: v.shape))
    for k, (n_half, n_rem) in enumerate(flow_widths(CFG)):
        W = p[f"convinv{k}/W"]
        assert W.shape == (n_rem, n_rem)
        torch.testing.assert_close(W @ W.T, torch.eye(n_rem), atol=1e-5,
                                   rtol=0)
        assert float(torch.linalg.det(W.detach())) == pytest.approx(
            1.0, abs=1e-5)
        assert not p[f"wn{k}/end/kernel"].any()
        for name in ("start", "cond", "in0", "res_skip1"):
            v, g = p[f"wn{k}/{name}/v"], p[f"wn{k}/{name}/g"]
            torch.testing.assert_close(
                g, v.reshape(-1, v.shape[-1]).norm(dim=0))
            assert not p[f"wn{k}/{name}/bias"].any()
    # lecun normal: variance 1 / fan_in, nothing past two (untruncated)
    # standard deviations
    v = p["wn0/cond/v"].detach()
    fan_in = v.shape[0] * v.shape[1]
    assert float(v.var()) == pytest.approx(1.0 / fan_in, rel=0.1)
    assert float(v.abs().max()) <= 2.0 / 0.87962566103423978 * fan_in ** -0.5
    # zero end convs: the coupling is the identity, z is the audio mixed by
    # rotations, so sum(z^2) = sum(audio^2) and both log terms are zero
    audio = torch.randn(2, 512, generator=gen) * 0.1
    with torch.no_grad():
        z, log_s, log_det = model(torch.randn(2, 8, 64, generator=gen), audio)
    assert float(log_s) == 0.0
    assert abs(float(log_det)) < 1e-2
    assert float(z.square().sum()) == pytest.approx(
        float(audio.square().sum()), rel=1e-4)
    # the same seed draws the same parameters; without one they are zero
    again = TrainableWaveGlow(CFG, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p[n], again.params[n]) for n in p.keys())
    assert not TrainableWaveGlow(CFG).params["wn0/start/v"].any()
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainableWaveGlow(CFG, compute_dtype=torch.float16)


def test_trained_weights_reach_the_serving_loader(setup):
    """``variables_from_trainable`` -> ``load_waveglow`` holds what folding
    the JAX tree holds, and the tree survives the round trip bit for bit."""
    params, _, _ = setup
    model = _port(params)
    flat = convert.variables_from_trainable(model)
    assert all(k.startswith("params/") for k in flat)
    want = _flat(params)
    for name, value in flat.items():
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, want[name[len("params/"):]])
    a = convert.load_waveglow(flat, CFG).state_dict()
    b = convert.load_waveglow({"params": params}, CFG).state_dict()
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    back = convert.trainable_waveglow_from_variables(flat, CFG)
    assert all(torch.equal(back.params[n], model.params[n])
               for n in model.params.keys())
    bad = dict(flat)
    bad.pop("params/wn0/end/bias")
    with pytest.raises(ValueError, match="do not match"):
        convert.trainable_waveglow_from_variables(bad, CFG)
    bad = dict(flat, **{"params/wn0/end/bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.trainable_waveglow_from_variables(bad, CFG)


def test_checkpoint_round_trip_params_only_and_mismatch(setup, tmp_path):
    params, mel, audio = setup
    model, _ = _one_step(params, mel, audio)
    state = create_train_state(model.params, LR)
    step = make_wg_train_step(model, CFG.sigma)
    batch = VocoderBatch(torch.from_numpy(mel), torch.from_numpy(audio))
    state, _ = step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    fresh_model = TrainableWaveGlow(CFG)
    fresh = create_train_state(fresh_model.params, LR)
    assert mgr.restore(fresh) == (fresh, 0)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3, 4] and mgr.latest_step() == 4
    saved = {n: p.detach().clone() for n, p in model.params.items()}
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]

    # whole restore: parameters, optimizer moments and step; the next step
    # from the restored state equals the next step of the original
    restored, at = mgr.restore(fresh, step=3)
    assert at == 3 and restored.step == 3
    for name, p in model.params.items():
        got = fresh_model.params[name]
        assert torch.equal(got, p) and got.dtype == p.dtype
    step(state, batch)
    make_wg_train_step(fresh_model, CFG.sigma)(restored, batch)
    for name, p in model.params.items():
        assert torch.equal(fresh_model.params[name], p), name

    # params_only keeps the fresh optimizer state
    other_model = TrainableWaveGlow(CFG)
    other = create_train_state(other_model.params, LR)
    _, at = mgr.restore(other, params_only=True)
    assert at == 4 and not other.opt.state_dict()["state"]
    assert all(torch.equal(other_model.params[n], v)
               for n, v in saved.items())

    # restored leaves take the template's dtype
    half_model = TrainableWaveGlow(CFG).to(torch.float64)
    mgr.restore(create_train_state(half_model.params, LR), params_only=True)
    assert half_model.params["wn0/cond/g"].dtype == torch.float64

    # another architecture: a pointed ValueError either way
    wide = TrainableWaveGlow(WaveGlowConfig(**{**TINY, "wn_n_channels": 8}))
    for params_only in (False, True):
        with pytest.raises(ValueError, match="params_only"):
            mgr.restore(create_train_state(wide.params, LR),
                        params_only=params_only)
    deep = TrainableWaveGlow(WaveGlowConfig(**{**TINY, "wn_n_layers": 3}))
    with pytest.raises(ValueError, match="does not match the model"):
        mgr.restore(create_train_state(deep.params, LR))
    # another optimizer layout: the error names the way out
    sgd_state = create_train_state(TrainableWaveGlow(CFG).params, LR)
    sgd_state.opt = torch.optim.SGD(
        [{"params": list(sgd_state.params.values())[:3]},
         {"params": list(sgd_state.params.values())[3:]}], lr=LR)
    with pytest.raises(ValueError, match="params_only=True"):
        mgr.restore(sgd_state)


# ---------------------------------------------------------------------------
# the trainer and the CLI, on the CPU
# ---------------------------------------------------------------------------

CLI_CFG = {
    "train_config": {"learning_rate": 1e-4, "sigma": 1.0,
                     "iters_per_checkpoint": 2, "batch_size": 2, "seed": 1},
    "data_config": {"segment_length": 2048, "sampling_rate": 22050,
                    "filter_length": 256, "hop_length": 64,
                    "win_length": 256, "mel_fmin": 0.0, "mel_fmax": 8000.0},
    "waveglow_config": {"n_mel_channels": 80, "n_flows": 2, "n_group": 4,
                        "n_early_every": 4, "n_early_size": 2,
                        "WN_config": {"n_layers": 2, "n_channels": 16,
                                      "kernel_size": 3}},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four synthetic wavs, a file list and a tiny config (as
    ``tests/test_cli.py`` makes its corpus)."""
    root = tmp_path_factory.mktemp("wgcorpus")
    rng = np.random.RandomState(0)
    for i in range(4):
        n = 8000 + 500 * i
        t = np.arange(n) / 22050
        sig = 0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t) \
            + 0.01 * rng.randn(n)
        wavfile.write(str(root / f"u{i}.wav"), 22050,
                      (sig * 32767).astype(np.int16))
    (root / "files.txt").write_text(
        "\n".join(f"u{i}.wav" for i in range(4)))
    (root / "wg.json").write_text(json.dumps(CLI_CFG))
    return root


def _cli(corpus, out, steps, *flags):
    return ["-c", str(corpus / "wg.json"), "--training_files",
            str(corpus / "files.txt"), "--output_directory", str(out),
            "--num_steps", str(steps), "--device", "cpu", *flags]


def test_cli_trains_and_resumes(corpus, tmp_path, capsys):
    out = tmp_path / "wg_out"
    trainer = waveglow_train.main(_cli(corpus, out, 2))
    assert trainer.state.step == 2
    assert trainer.ckpt.all_steps() == [2]
    before = {n: p.detach().clone() for n, p in trainer.model.params.items()}
    capsys.readouterr()
    resumed = waveglow_train.main(_cli(corpus, out, 3, "--remat"))
    assert "Resumed WaveGlow from step 2" in capsys.readouterr().out
    assert resumed.state.step == 3
    assert resumed.ckpt.all_steps() == [2, 3]
    assert resumed.model.remat
    assert any(not torch.equal(before[n], p)
               for n, p in resumed.model.params.items())
    # the resumed run went on from the saved moments, not from fresh ones
    saved = torch.load(str(out / "ckpt_00000003.pt"), weights_only=True)
    assert saved["step"] == 3
    assert set(saved["params"]) == set(before)
    assert float(saved["opt_state"]["state"][0]["step"]) == 3.0


def test_cli_as_a_module_with_bf16_and_grad_accum(corpus, tmp_path):
    """``python -m text2speech_tpu_torch.waveglow_train`` in a process of
    its own, with ``--bf16 --grad_accum 2``; the scalars are logged as JSON
    lines where tensorboardX is absent."""
    out = tmp_path / "wg_mod"
    r = subprocess.run(
        [sys.executable, "-m", "text2speech_tpu_torch.waveglow_train",
         *_cli(corpus, out, 10, "--bf16", "--grad_accum", "2")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "compute dtype bf16" in r.stdout and "wg step 10" in r.stdout
    assert (out / "ckpt_00000010.pt").exists()
    tb = out / "tb"
    assert tb.is_dir() and list(tb.iterdir())
    scalars = tb / "scalars.jsonl"
    if scalars.exists():
        line = json.loads(scalars.read_text().splitlines()[-1])
        assert line["iteration"] == 10 and np.isfinite(line["training.loss"])
        assert set(line) == {"iteration", "training.loss", "grad.norm",
                             "learning.rate", "duration"}


def test_cli_raises_without_a_gpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        waveglow_train.main(_cli(corpus, tmp_path / "o", 1)[:-2])


def test_trainer_interrupt_and_empty_dataset(corpus, tmp_path, monkeypatch):
    cfg = WaveGlowConfig.from_json(str(corpus / "wg.json"))
    trainer = WaveGlowTrainer(cfg, str(corpus / "files.txt"),
                              str(tmp_path / "int"), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    real = trainer._train_step
    calls = []

    def interrupted(state, batch):
        if calls:
            raise KeyboardInterrupt
        calls.append(1)
        return real(state, batch)

    monkeypatch.setattr(trainer, "_train_step", interrupted)
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(5)
    assert trainer.ckpt.all_steps() == [1]

    big = dataclasses.replace(cfg, batch_size=8)
    empty = WaveGlowTrainer(big, str(corpus / "files.txt"),
                            str(tmp_path / "empty"), device="cpu")
    with pytest.raises(ValueError, match="0 batches"):
        empty.fit(1)
    with pytest.raises(ValueError, match="grad_accum"):
        WaveGlowTrainer(cfg, str(corpus / "files.txt"),
                        str(tmp_path / "ga"), grad_accum=3, device="cpu")
