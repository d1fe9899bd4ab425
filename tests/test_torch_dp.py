"""Data parallelism in the port's trainers (``mesh=`` of
``train/tacotron.py`` and ``train/waveglow.py``, over
``parallel/mesh.py``) on a two-rank gloo group on the CPU, against the JAX
package's data-parallel steps on a two-device CPU mesh and against the
port's own one-process steps.  ``tests/test_torch_mesh.py`` holds the
mesh itself, ``infer_long(mesh=)``, the TP grid and the CLI.

Two processes, one rank each, run every step once (spawned once for the
file, killed after 150 s); the JAX references and the one-process port
steps run in this process meanwhile.  Each rank is given the GLOBAL batch
and masks; it keeps its rows.

* Tacotron: the tiny model of ``tests/test_torch_tacotron_train.py`` (two
  speakers, rows of unequal lengths) with the Noam warm-up of the JAX
  package's own DP test (``tests/test_train_infra.py:57-85``: the first
  rate is ``lr / 4000``), ``grad_accum`` 1 (4 rows) and 2 (8 rows, whose
  strided microbatches are the 4 rows and a permuted, perturbed copy), the
  dropout masks JAX drew for each microbatch.  Against the JAX step
  sharded over two devices, JAX's own DP tolerances: loss ``rel=1e-5``,
  parameters max-abs ``< 1e-5``, BatchNorm running statistics ``< 1e-5``
  (the sync-BN property, ``test_train_infra.py:398-430``), and the
  gradient's global norm ``rel=1e-5``.  Against the port's one-process
  step on the global batch: ``rel=1e-6`` and ``< 1e-6``, and Adam's first
  moment (a tenth of the clipped gradient, summed in another order) within
  1e-5 of its largest entry.  With no masks given, the ranks draw them
  from the generator at the global microbatch's shape: the one-process
  step's numbers, to the same bounds.
* WaveGlow: the tiny model of ``tests/test_torch_waveglow_train.py``,
  ``grad_accum`` 1 and 2, to the same bounds, but for the loss against
  JAX: a difference of terms of about 1 that nearly cancel (0.018 here),
  held as there to 1e-7 absolute (1e-5 of its terms)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests.test_torch_tacotron_train import (SPEAKERS, TINY as TACO_TINY,
                                             _batch as taco_batch,
                                             jax_value_and_grad)
from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.config import WaveGlowConfig as JaxWGConfig
from text2speech_tpu.data.dataset import Batch as JaxBatch
from text2speech_tpu.data.mel2samp import VocoderBatch as JaxVocoderBatch
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu.train.state import TrainState as JaxTrainState
from text2speech_tpu.train.state import create_train_state as jax_state
from text2speech_tpu.train.tacotron import make_train_step as jax_taco_step
from text2speech_tpu.train.waveglow import make_wg_train_step as jax_wg_step
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.data.dataset import Batch
from text2speech_tpu_torch.data.mel2samp import VocoderBatch
from text2speech_tpu_torch.train.state import (create_tacotron_state,
                                               create_train_state)
from text2speech_tpu_torch.train.tacotron import make_train_step
from text2speech_tpu_torch.train.waveglow import make_wg_train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TACO = dict(TACO_TINY, warmup_steps=4000)
HP, JHP = HParams(**TACO), JaxHParams(**TACO)
WG = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
          n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          upsample_kernel=32, upsample_stride=8, segment_length=512,
          learning_rate=1e-3, sigma=0.9)
WCFG, JWCFG = WaveGlowConfig(**WG), JaxWGConfig(**WG)
LOSS_ATOL = 1e-7

_WORKER = """
import sys
import numpy as np
import torch
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.parallel import mesh as pm
from text2speech_tpu_torch.text import N_SYMBOLS
from text2speech_tpu_torch.train.state import (create_tacotron_state,
                                               create_train_state)
from text2speech_tpu_torch.train.tacotron import make_train_step
from text2speech_tpu_torch.train.waveglow import make_wg_train_step

port, rank, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
assert pm.initialize_distributed(f"tcp://localhost:{port}", 2, rank,
                                 device="cpu")
try:
    d = torch.load(inp, weights_only=False)
    mesh = pm.make_mesh()
    assert mesh.shape == (2,) and mesh.rank() == rank
    hp, wcfg = HParams(**d["taco_hp"]), WaveGlowConfig(**d["wg_cfg"])
    res = {}

    def taco(ga, masks=None, generator=None):
        model = convert.trainable_tacotron_from_variables(
            d["taco_vars"], hp, N_SYMBOLS, d["speakers"])
        state = create_tacotron_state(model, hp)
        _, m = make_train_step(model, hp, ga, mesh)(
            state, d[f"taco_batch{ga}"], generator=generator, masks=masks)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "sd": model.state_dict(),
                "mu": {n: state.opt.state[p]["exp_avg"]
                       for n, p in state.params.items()}}

    for ga in (1, 2):
        res[f"taco{ga}"] = taco(ga, masks=d[f"taco_masks{ga}"])
    res["taco_gen"] = taco(2, generator=torch.Generator().manual_seed(7))
    for ga in (1, 2):
        model = convert.trainable_waveglow_from_variables(
            {"params": d["wg_params"]}, wcfg)
        state = create_train_state(model.params, wcfg.learning_rate)
        _, m = make_wg_train_step(model, wcfg.sigma, ga, mesh)(
            state, d["wg_batch"])
        res[f"wg{ga}"] = {"metrics": {k: float(v) for k, v in m.items()},
                          "params": {n: p.detach().clone()
                                     for n, p in model.params.items()}}
    torch.save(res, out)
finally:
    pm.destroy_distributed()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _perturbed(variables, scale, seed):
    prng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * prng.randn(*x.shape).astype(
            np.float32), variables)


def _taco_inputs():
    """The JAX model, its perturbed variables, the 4- and 8-row batches
    and the masks JAX drew: one per microbatch, all of 4 rows (one
    compiled forward)."""
    b = taco_batch()
    rng = np.random.RandomState(5)
    perm = [1, 0, 3, 2]
    b2 = JaxBatch(*(np.asarray(x)[perm] for x in b))
    b2 = b2._replace(mel=(b2.mel + 0.1 * rng.randn(*b2.mel.shape).astype(
        np.float32) * (b2.mel != 0)).astype(np.float32))
    # strided microbatches of the 8 rows: rows 0::2 are b, rows 1::2 are b2
    b8 = JaxBatch(*(np.stack([x, y], 1).reshape((8,) + x.shape[1:])
                    for x, y in zip(b, b2)))
    jb = JaxBatch(*map(jnp.asarray, b))
    key = jax.random.PRNGKey(0)
    model = JaxTacotron2(JHP, n_vocab=N_SYMBOLS, num_speakers=SPEAKERS)
    variables = jax.jit(model.init)(
        {"params": key, "dropout": key}, jb.text, jb.input_lengths, jb.mel,
        jb.output_lengths, speaker_ids=jb.speaker_id)
    variables = {"params": _perturbed(variables["params"], 0.05, 1),
                 "batch_stats": jax.tree.map(np.asarray,
                                             variables["batch_stats"])}
    key = jax.random.PRNGKey(7)
    masks = {1: jax_value_and_grad(model, variables, jb, key)[3]}
    keys = jax.random.split(key, 2)
    masks[2] = [jax_value_and_grad(model, variables,
                                   JaxBatch(*map(jnp.asarray, mb)), k)[3]
                for mb, k in zip((b, b2), keys)]
    return model, {1: b, 2: b8}, variables, key, masks


def _jax_dp(step_fn, state, batch):
    """One JAX step with the batch sharded over two CPU devices and the
    state replicated (``tests/test_train_infra.py:66-71``)."""
    mesh = Mesh(np.asarray(jax.devices("cpu")[:2]), ("data",))
    rep, dp = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    state = jax.tree.map(lambda x: jax.device_put(x, rep), state)
    batch = type(batch)(*[jax.device_put(np.asarray(x), dp) for x in batch])
    return step_fn(state, batch)


def _torch_batch(b) -> Batch:
    return Batch(*(torch.from_numpy(np.asarray(x)) for x in b))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results, the JAX references and the port's
    one-process results."""
    tmp = tmp_path_factory.mktemp("dp")
    jtaco, batches, tvars, key, jmasks = _taco_inputs()
    rng = np.random.RandomState(0)
    frames = WCFG.segment_length // WCFG.upsample_stride
    mel = rng.randn(4, WCFG.n_mel_channels, frames).astype(np.float32)
    audio = (0.1 * rng.randn(4, WCFG.segment_length)).astype(np.float32)
    wvars = jax.jit(JaxWaveGlow(JWCFG).init)(
        jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(audio))
    wparams = _perturbed(wvars["params"], 0.01, 1)
    inputs = {
        "taco_hp": TACO, "taco_vars": tvars, "speakers": SPEAKERS,
        "taco_batch1": _torch_batch(batches[1]),
        "taco_batch2": _torch_batch(batches[2]),
        "taco_masks1": jmasks[1], "taco_masks2": jmasks[2],
        "wg_cfg": WG, "wg_params": wparams,
        "wg_batch": VocoderBatch(torch.from_numpy(mel),
                                 torch.from_numpy(audio)),
    }
    torch.save(inputs, tmp / "inputs.pt")
    script = tmp / "worker.py"
    script.write_text(textwrap.dedent(_WORKER))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(r),
         str(tmp / "inputs.pt"), str(tmp / f"out{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        ref = _references(jtaco, batches, tvars, key, jmasks, mel, audio,
                          wparams, inputs)
        logs = []
        for pr in procs:
            out, _ = pr.communicate(timeout=150)
            logs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait(timeout=10)
    assert [pr.returncode for pr in procs] == [0, 0], "\n".join(logs)
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(2)]
    return ranks, ref


def _references(jtaco, batches, tvars, key, jmasks, mel, audio, wparams,
                inputs) -> dict:
    ref = {}
    for ga in (1, 2):
        step = jax.jit(jax_taco_step(jtaco, JHP, grad_accum=ga))
        jstate, jm = _jax_dp(lambda s, x: step(s, x, key),
                             jax_state(JHP, tvars),
                             JaxBatch(*map(jnp.asarray, batches[ga])))
        ref[f"jax_taco{ga}"] = (
            {k: float(v) for k, v in jm.items()},
            convert.flatten_tree({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}))
    for name, ga, kw in (("taco1", 1, {"masks": jmasks[1]}),
                         ("taco2", 2, {"masks": jmasks[2]}),
                         ("taco_gen", 2, {
                             "generator": torch.Generator().manual_seed(7)})):
        model = convert.trainable_tacotron_from_variables(tvars, HP,
                                                          N_SYMBOLS, SPEAKERS)
        state = create_tacotron_state(model, HP)
        _, m = make_train_step(model, HP, ga)(
            state, inputs[f"taco_batch{ga}"], **kw)
        ref[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "sd": model.state_dict(),
                     "mu": {n: state.opt.state[p]["exp_avg"]
                            for n, p in state.params.items()}}
    model = convert.trainable_tacotron_from_variables(tvars, HP, N_SYMBOLS,
                                                      SPEAKERS)
    rows = slice(0, 2)
    make_train_step(model, HP)(
        create_tacotron_state(model, HP),
        Batch(*(x[rows] for x in inputs["taco_batch1"])),
        masks=jmasks[1].rows(rows))
    ref["taco_rows01"] = model.state_dict()
    tx = optax.adam(WCFG.learning_rate)
    for ga in (1, 2):
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=wparams,
                               batch_stats={}, opt_state=tx.init(wparams),
                               tx=tx)
        step = jax.jit(jax_wg_step(JaxWaveGlow(JWCFG), WCFG.sigma,
                                   grad_accum=ga))
        jstate, jm = _jax_dp(step, jstate, JaxVocoderBatch(mel, audio))
        ref[f"jax_wg{ga}"] = ({k: float(v) for k, v in jm.items()},
                              convert.flatten_tree(
                                  {"params": jstate.params}))
        model = convert.trainable_waveglow_from_variables(
            {"params": wparams}, WCFG)
        state = create_train_state(model.params, WCFG.learning_rate)
        _, m = make_wg_train_step(model, WCFG.sigma, ga)(
            state, inputs["wg_batch"])
        ref[f"wg{ga}"] = {"metrics": {k: float(v) for k, v in m.items()},
                          "params": {n: p.detach().clone()
                                     for n, p in model.params.items()}}
    return ref


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def test_both_ranks_hold_the_same_state(run):
    """Every rank applies the same averaged gradients: bit for bit."""
    ranks = run[0]
    for name in ("taco1", "taco2", "taco_gen"):
        a, b = ranks[0][name], ranks[1][name]
        assert a["metrics"] == b["metrics"], name
        assert all(torch.equal(a["sd"][k], b["sd"][k]) for k in a["sd"])
    for name in ("wg1", "wg2"):
        a, b = ranks[0][name], ranks[1][name]
        assert a["metrics"] == b["metrics"], name
        assert all(torch.equal(a["params"][k], b["params"][k])
                   for k in a["params"])


@pytest.mark.parametrize("ga", [1, 2])
def test_tacotron_step_matches_the_jax_dp_step(run, ga):
    ranks, ref = run[0], run[1]
    jm, want = ref[f"jax_taco{ga}"]
    got = ranks[0][f"taco{ga}"]
    assert got["metrics"]["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    assert got["metrics"]["grad_norm"] == pytest.approx(jm["grad_norm"],
                                                        rel=1e-5)
    assert jm["grad_norm"] > HP.grad_clip_norm     # the clip takes part
    n_stats = 0
    for dst, src, kind in convert.tacotron_layout(HP, SPEAKERS):
        diff = _max_diff(got["sd"][dst],
                         convert.to_port_layout(want[src], kind))
        assert diff < 1e-5, (dst, diff)
        n_stats += dst.endswith(("running_mean", "running_var"))
    # the encoder's two and the postnet's three BatchNorms
    assert n_stats == 2 * (TACO["enc_conv_num_layers"]
                           + TACO["postnet_n_convolutions"])


@pytest.mark.parametrize("name,ga", [("taco1", 1), ("taco2", 2),
                                     ("taco_gen", 2)])
def test_tacotron_step_matches_the_one_process_step(run, name, ga):
    ranks, ref = run[0], run[1]
    got, want = ranks[0][name], ref[name]
    for k in ("loss", "mel_loss", "gate_loss", "grad_norm"):
        assert got["metrics"][k] == pytest.approx(want["metrics"][k],
                                                  rel=1e-6), k
    for k, t in want["sd"].items():
        assert _max_diff(got["sd"][k], t) < 1e-6, k
    peak = max(float(m.abs().max()) for m in want["mu"].values())
    for k, m in want["mu"].items():
        assert _max_diff(got["mu"][k], m) <= 1e-5 * peak, k


def test_batch_norm_statistics_are_global(run):
    """The sync-BN property: the ranks' running statistics are the global
    batch's, while a step on rank 0's two rows alone stores others (so the
    bound above can fail)."""
    ranks, ref = run[0], run[1]
    got, want = ranks[0]["taco1"]["sd"], ref["taco1"]["sd"]
    local = ref["taco_rows01"]
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (TACO["enc_conv_num_layers"]
                              + TACO["postnet_n_convolutions"])
    for k in names:
        assert _max_diff(got[k], want[k]) < 1e-6, k
    assert max(_max_diff(local[k], want[k]) for k in names) > 1e-3


@pytest.mark.parametrize("ga", [1, 2])
def test_waveglow_step_matches_jax_and_one_process(run, ga):
    ranks, ref = run[0], run[1]
    got = ranks[0][f"wg{ga}"]
    jm, want = ref[f"jax_wg{ga}"]
    assert got["metrics"]["loss"] == pytest.approx(jm["loss"],
                                                   abs=LOSS_ATOL)
    assert got["metrics"]["grad_norm"] == pytest.approx(jm["grad_norm"],
                                                        rel=1e-5)
    for n, p in got["params"].items():
        assert _max_diff(p, torch.from_numpy(np.array(
            want[f"params/{n}"]))) < 1e-5, n
    one = ref[f"wg{ga}"]
    for k in ("loss", "grad_norm"):
        assert got["metrics"][k] == pytest.approx(one["metrics"][k],
                                                  rel=1e-6), k
    for n, p in one["params"].items():
        assert _max_diff(got["params"][n], p) < 1e-6, n
