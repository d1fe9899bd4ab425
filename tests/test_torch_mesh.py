"""The port's mesh (``text2speech_tpu_torch/parallel/mesh.py``) against the
JAX package's (``text2speech_tpu/parallel/mesh.py``), and the paths built
on it that need more than two ranks: ``infer_long(mesh=)``, the TP
vocoder's data x model grid and the training CLI on a world larger than
its data mesh.

In this process: ``initialize_distributed``'s trigger logic (mirroring
``tests/test_train_infra.py:441-479`` with a monkeypatched environment and
no real init), the backend rule, ``make_data_mesh``'s sizes and
``check_grad_accum_mesh`` against the JAX functions case by case,
``shard_batch``'s rows and the microbatch-of-a-shard property the trainers
rely on.

Four processes, one rank each over gloo, run the rest once (spawned once
for the file, killed after 150 s) while the references run here:

* groups: the (4,) and (2, 2) meshes, each axis' group summing the right
  ranks; ``make_data_mesh(6)`` on 4 ranks is 3 ranks, the fourth outside;
  ``shard_batch`` / ``gather_rows``; ``replicate`` of a module and a train
  state from the first rank; ``all_reduce_mean_``;
* ``infer_long(mesh=)`` on a data mesh of ranks 0-1 (ranks 2-3 outside):
  200 frames in 7 windows padded to 8, against JAX
  ``infer_long(mesh=Mesh(cpu[:2]))`` at ``atol=1e-5``
  (``tests/test_chunked.py:289-318``) and, through the plain, fused f32
  and int8 vocoders, against the port's one-process calls, 1e-6;
* the TP vocoder on a 2 x 2 (data x model) grid: fused f32 against the JAX
  ``TPWaveGlowServer`` on a (2, 2) data x model mesh at ``atol=3e-4``
  (``tests/test_tp.py:93-115``'s bound), and the plain, fused and int8
  grids against the port's one-process two-shard servers, 1e-6; noise from
  a generator is drawn at the global shape;
* ``waveglow_train.main`` and ``tacotron_train.main`` with batch 2 on 4
  ranks: ranks 0-1 train data-parallel (rank 0 alone writes; one
  checkpoint; a resume; Tacotron's one run directory), equal to a
  one-process run to 1e-6; ranks 2-3 refuse with an error naming the
  batch and the world."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from tests.test_torch_tacotron_data import HP as DATA_HP
from tests.test_torch_tacotron_data import write_corpus as write_taco_corpus
from text2speech_tpu.config import WaveGlowConfig as JaxWGConfig
from text2speech_tpu.models import chunked as jchunked
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.parallel import mesh as jmesh
from text2speech_tpu.parallel import tp as jtp
from text2speech_tpu.train.state import check_grad_accum_mesh as jax_check
from text2speech_tpu_torch import convert, tacotron_train, waveglow_train
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.models import chunked
from text2speech_tpu_torch.models.waveglow import noise_shapes
from text2speech_tpu_torch.models.waveglow_fused import (prepare_fused,
                                                         prepare_fused_int8)
from text2speech_tpu_torch.parallel import mesh as pm
from text2speech_tpu_torch.parallel import tp as ttp
from text2speech_tpu_torch.train.state import (check_grad_accum_mesh,
                                               microbatch_split)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG = dict(n_mel_channels=16, n_flows=6, n_group=8, n_early_every=2,
            n_early_size=2, wn_n_layers=3, wn_n_channels=32,
            wn_kernel_size=3, upsample_kernel=64, upsample_stride=16,
            segment_length=1024)
TPK = dict(n_mel_channels=16, n_flows=4, n_group=8, n_early_every=2,
           n_early_size=2, wn_n_layers=3, wn_n_channels=32,
           wn_kernel_size=3, upsample_kernel=64, upsample_stride=16)
FRAMES, SIGMA, CHUNK, OVERLAP = 200, 0.9, 32, 64
TP_B, TP_FRAMES, TP_SIGMA = 2, 24, 0.8
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


def fake_mesh(n: int, r: int, shape=None, names=(pm.DATA_AXIS,)) -> pm.Mesh:
    """A mesh value without a process group, for what needs only sizes and
    this rank's place."""
    shape = shape or (n,)
    coords = tuple(int(c) for c in np.unravel_index(r, shape))
    return pm.Mesh(tuple(names), tuple(shape), (None,) * len(shape), coords,
                   torch.device("cpu"), int(np.prod(shape)))


# --- in this process ---------------------------------------------------------


def test_initialize_distributed_trigger_logic(monkeypatch):
    """Tuning kwargs alone do not initialize; an address or torchrun's
    ``WORLD_SIZE`` > 1 does; a second call is a no-op; the backend and the
    device follow :func:`choose_backend`; asked for a card without one, it
    raises."""
    import torch.distributed as dist

    calls = []
    state = {"up": False}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: (calls.append(kw),
                                      state.update(up=True)))
    monkeypatch.setattr(dist, "is_initialized", lambda: state["up"])
    monkeypatch.setattr(pm, "_RUNTIME", {})
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)

    assert pm.initialize_distributed() is False
    assert pm.initialize_distributed(timeout=None, device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pm.initialize_distributed() is False
    assert calls == []

    assert pm.initialize_distributed("tcp://h:1234", 2, 1,
                                     device="cpu") is True
    assert calls[-1] == {"backend": "gloo", "world_size": 2, "rank": 1,
                         "init_method": "tcp://h:1234"}
    assert pm.rank_device() == torch.device("cpu")
    n = len(calls)
    assert pm.initialize_distributed("tcp://h:1234", 2, 1) is True
    assert len(calls) == n                 # a second call is a no-op

    state["up"] = False
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert pm.initialize_distributed(device="cpu") is True
    assert calls[-1] == {"backend": "gloo", "world_size": 4, "rank": 2}

    state["up"] = False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.initialize_distributed(device="cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        pm.initialize_distributed(device="meta")


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "gloo")])
def test_backend_rule(device, local_world, cards, want):
    """NCCL only when every local rank has a card of its own."""
    assert pm.choose_backend(device, local_world, cards) == want


@pytest.mark.parametrize("batch,world", [
    (8, 8), (6, 8), (7, 8), (2, 8), (12, 8), (3, 4), (4, 4), (1, 2),
    (5, 2), (32, 1)])
def test_data_mesh_size_matches_jax(batch, world):
    """The most ranks that divide the batch, as the JAX
    ``make_data_mesh`` picks devices (``mesh.py:82-90``)."""
    want = jmesh.make_data_mesh(batch, jax.devices("cpu")[:world]).devices
    assert pm.data_mesh_size(batch, world) == want.size


CHECK_CASES = [(8, 1, (8,)), (8, 2, (4,)), (8, 2, (8,)), (8, 3, (2,)),
               (12, 3, (2,)), (6, 2, (4,)), (16, 4, (2,)), (4, 4, (2,)),
               (16, 2, (4, 2)), (8, 2, (4, 2)), (8, 4, (1, 4))]


@pytest.mark.parametrize("batch,ga,shape", CHECK_CASES)
def test_check_grad_accum_mesh_matches_jax(batch, ga, shape):
    """Raises exactly where the JAX function raises, with its message."""
    names = ("data", "model")[:len(shape)]
    jm = JaxMesh(np.asarray(jax.devices("cpu")[:int(np.prod(shape))])
                 .reshape(shape), names)
    tm = fake_mesh(None, 0, shape, names)

    def outcome(fn, mesh):
        try:
            fn(batch, ga, mesh)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jax_check, jm)
    assert outcome(check_grad_accum_mesh, tm) == want
    assert check_grad_accum_mesh(batch, ga, None) is None


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_batch_takes_contiguous_rows(n):
    """Each rank's contiguous block of every leaf; the blocks in rank
    order are the global batch."""
    from text2speech_tpu_torch.data.mel2samp import VocoderBatch

    batch = VocoderBatch(torch.arange(8 * 3).reshape(8, 3),
                         np.arange(8 * 5, dtype=np.float32).reshape(8, 5))
    tree = {"b": batch, "l": [torch.arange(8)], "s": "kept"}
    parts = [pm.shard_batch(tree, fake_mesh(n, r)) for r in range(n)]
    for r, part in enumerate(parts):
        assert isinstance(part["b"], VocoderBatch) and part["s"] == "kept"
        k = 8 // n
        assert part["l"][0].tolist() == list(range(r * k, (r + 1) * k))
        assert torch.is_tensor(part["b"].audio)
    assert torch.equal(torch.cat([p["b"].mel for p in parts]), batch.mel)
    if n > 1:
        with pytest.raises(ValueError, match="do not split"):
            pm.shard_batch(torch.zeros(n + 1), fake_mesh(n, 0))


@pytest.mark.parametrize("ga,n,k", [(2, 2, 1), (2, 2, 3), (3, 4, 2),
                                    (4, 2, 2)])
def test_a_ranks_microbatch_is_a_block_of_the_global_one(ga, n, k):
    """``check_grad_accum_mesh``'s docstring: with B = ga n k, rank r's
    strided microbatch i of its contiguous block is rows [r k, (r + 1) k)
    of the global microbatch i."""
    B = ga * n * k
    x = torch.arange(B)
    check_grad_accum_mesh(B, ga, fake_mesh(n, 0))
    glob = microbatch_split(x, ga)
    for r in range(n):
        local = microbatch_split(pm.shard_batch(x, fake_mesh(n, r)), ga)
        for i in range(ga):
            assert torch.equal(local[i], glob[i][r * k:(r + 1) * k])


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pm.make_mesh()
    assert pm.default_data_mesh(8) is None
    with pytest.raises(ValueError, match="outside"):
        pm.Mesh(("data",), (2,), (None,), None, torch.device("cpu"),
                4).rank()
    assert fake_mesh(2, 1).size("model") == 1
    assert fake_mesh(2, 1).rank("model") == 0


# --- four processes ----------------------------------------------------------

_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from text2speech_tpu_torch import convert, tacotron_train, waveglow_train
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.models import chunked
from text2speech_tpu_torch.models.waveglow_fused import (prepare_fused,
                                                         prepare_fused_int8)
from text2speech_tpu_torch.parallel import mesh as pm
from text2speech_tpu_torch.parallel.tp import TPWaveGlowServer
from text2speech_tpu_torch.train.checkpoint import CheckpointManager
from text2speech_tpu_torch.train.state import create_train_state

port, rank, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
assert pm.initialize_distributed(f"tcp://localhost:{port}", 4, rank,
                                 device="cpu")
try:
    d = torch.load(inp, weights_only=False)
    res = {}
    # --- groups
    flat = pm.make_mesh()
    grid = pm.make_mesh((2, 2), (pm.DATA_AXIS, pm.MODEL_AXIS))
    data6 = pm.make_data_mesh(6)
    pair = pm.make_mesh((2,))
    res["shapes"] = (flat.shape, flat.coords, grid.shape, grid.coords,
                     data6.shape, data6.member, pair.member)
    sums = {}
    for name, m, ax in (("flat", flat, pm.DATA_AXIS),
                        ("grid_data", grid, pm.DATA_AXIS),
                        ("grid_model", grid, pm.MODEL_AXIS)):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=m.group(ax))
        sums[name] = float(t)
    res["sums"] = sums
    try:
        pm.require_member(data6, 6)
        res["outside"] = None
    except ValueError as e:
        res["outside"] = str(e)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    mine = pm.shard_batch(x, flat)
    res["shard"] = mine
    res["gathered"] = pm.gather_rows(mine * 2, flat)
    mod = torch.nn.Linear(3, 2)
    with torch.no_grad():
        mod.weight.fill_(rank)
        mod.bias.fill_(10 + rank)
    pm.replicate(mod, flat)
    sums = [float(p.detach().sum()) for p in mod.parameters()]
    state = create_train_state(mod, 1e-3)
    mod(torch.ones(1, 3)).sum().backward()
    state.opt.step()                     # Adam state to replicate
    for st in state.opt.state.values():
        st["exp_avg"].fill_(rank)
    pm.replicate(state, flat)
    res["replicated"] = (sums, [float(st["exp_avg"].sum())
                                for st in state.opt.state.values()])
    means = [torch.tensor([float(rank), 1.0]), torch.tensor(2.0 * rank)]
    pm.all_reduce_mean_(means, flat)
    res["means"] = [m.tolist() for m in means]
    # --- infer_long on a data mesh of ranks 0-1
    if pair.member:
        wg = convert.load_waveglow({"params": d["long_params"]},
                                   WaveGlowConfig(**d["long_cfg"]))
        kw = dict(sigma=d["sigma"], chunk_frames=d["chunk"],
                  overlap_frames=d["overlap"], noise=d["long_noise"],
                  mesh=pair)
        res["long"] = {
            "plain": chunked.infer_long(wg, d["long_spect"], **kw),
            "fused": chunked.infer_long(prepare_fused(wg, torch.float32),
                                        d["long_spect"], **kw),
            "int8": chunked.infer_long(prepare_fused_int8(wg, torch.float32),
                                       d["long_spect"], **kw)}
    # --- the TP grid
    tpm = convert.load_waveglow({"params": d["tp_params"]},
                                WaveGlowConfig(**d["tp_cfg"]))
    res["tp"] = {}
    for name, kw in (("plain", dict(fused=False)),
                     ("fused", dict(compute_dtype=torch.float32)),
                     ("int8", dict(int8=True, compute_dtype=torch.float32))):
        server = TPWaveGlowServer(tpm, mesh=grid, **kw)
        assert server.ranks == [grid.rank(pm.MODEL_AXIS)]
        assert server.n_model == 2
        res["tp"][name] = server(d["tp_spect"], d["tp_sigma"],
                                 noise=d["tp_noise"])
    res["tp"]["generator"] = TPWaveGlowServer(
        tpm, mesh=grid, compute_dtype=torch.float32)(
        d["tp_spect"], d["tp_sigma"],
        generator=torch.Generator().manual_seed(5))
    # --- the training CLI: batch 2 on 4 ranks (every rank calls it each
    # time: building the data mesh is collective)
    runs, saved = [], []
    for steps in ("2", "3"):
        try:
            runs.append(waveglow_train.main(d["cli"] + ["--num_steps",
                                                        steps]))
            saved.append(runs[-1].ckpt.all_steps())
        except ValueError as e:
            runs.append(str(e))
    trainer, resumed = runs
    if isinstance(trainer, str):
        res["cli"] = trainer
    else:
        res["cli"] = {"mesh": trainer.mesh.shape,
                      "writer": trainer.ckpt.writer,
                      "steps": saved[0],
                      "resumed": (resumed.state.step, saved[1]),
                      "params": {n: p.detach().clone()
                                 for n, p in trainer.model.params.items()}}
    try:
        taco = tacotron_train.main(d["taco_cli"])
        res["taco_cli"] = {
            "run_dir": taco.run_dir, "mesh": taco.mesh.shape,
            "writer": taco.ckpt.writer, "steps": taco.ckpt.all_steps(),
            "loss": float(taco.last_metrics["loss"]),
            "sd": {n: t.clone() for n, t in taco.model.state_dict().items()}}
    except ValueError as e:
        res["taco_cli"] = str(e)
    torch.save(res, out)
finally:
    pm.destroy_distributed()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _perturbed(params, scale, seed):
    prng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * prng.randn(*x.shape).astype(
            np.float32), params)


def _init(kw, frames):
    cfg = JaxWGConfig(**kw)
    model = JaxWaveGlow(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.n_mel_channels, frames)),
        jnp.zeros((1, frames * cfg.upsample_stride)))
    return model, _perturbed(variables["params"], 0.01, 1)


def _corpus(root):
    rng = np.random.RandomState(0)
    for i in range(4):
        n = 8000 + 500 * i
        t = np.arange(n) / 22050
        sig = 0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t) \
            + 0.01 * rng.randn(n)
        wavfile.write(str(root / f"u{i}.wav"), 22050,
                      (sig * 32767).astype(np.int16))
    (root / "files.txt").write_text("\n".join(f"u{i}.wav"
                                              for i in range(4)))
    (root / "wg.json").write_text(json.dumps(CLI_CFG))
    return ["-c", str(root / "wg.json"), "--training_files",
            str(root / "files.txt"), "--device", "cpu"]


def _taco_cli(tmp, name) -> list:
    """``tacotron_train``'s arguments for two steps on a six-utterance
    corpus at a tiny width, batch 2 (the corpus and hparams of
    ``tests/test_torch_tacotron_data.py``)."""
    corpus = tmp / "kss"
    if not corpus.exists():
        write_taco_corpus(corpus)
        DATA_HP.save(str(tmp / "tiny.json"))
    return ["--data_paths", str(corpus), "--log_dir", str(tmp / name),
            "--hparams", str(tmp / "tiny.json"), "--checkpoint_interval",
            "1", "--num_steps", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    lmodel, lparams = _init(LONG, 20)
    lcfg = WaveGlowConfig(**LONG)
    rng = np.random.RandomState(3)
    spect = rng.randn(1, lcfg.n_mel_channels, FRAMES).astype(np.float32)
    gpf = lcfg.upsample_stride // lcfg.n_group
    noise = [rng.randn(1, FRAMES * gpf, w).astype(np.float32)
             for w in chunked.noise_schedule(lcfg)]
    tmodel, tparams = _init(TPK, 20)
    tcfg = WaveGlowConfig(**TPK)
    trng = np.random.RandomState(0)
    tspect = trng.randn(TP_B, tcfg.n_mel_channels, TP_FRAMES).astype(
        np.float32)
    tgpf = tcfg.upsample_stride // tcfg.n_group
    tnoise = tuple(trng.randn(*s).astype(np.float32)
                   for s in noise_shapes(tcfg, TP_B, TP_FRAMES * tgpf))
    cli = _corpus(tmp)
    inputs = {
        "long_cfg": LONG, "long_params": lparams,
        "long_spect": torch.from_numpy(spect),
        "long_noise": tuple(torch.from_numpy(z) for z in noise),
        "sigma": SIGMA, "chunk": CHUNK, "overlap": OVERLAP,
        "tp_cfg": TPK, "tp_params": tparams,
        "tp_spect": torch.from_numpy(tspect),
        "tp_noise": tuple(torch.from_numpy(z) for z in tnoise),
        "tp_sigma": TP_SIGMA,
        "cli": cli + ["--output_directory", str(tmp / "dp_out")],
        "taco_cli": _taco_cli(tmp, "dp"),
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
        for r in range(4)]
    try:
        ref = {"jax_long": np.asarray(jchunked.infer_long(
            lmodel, {"params": lparams}, jnp.asarray(spect), None,
            sigma=SIGMA, chunk_frames=CHUNK, overlap_frames=OVERLAP,
            noise=tuple(jnp.asarray(z) for z in noise),
            mesh=JaxMesh(np.asarray(jax.devices("cpu")[:2]), ("data",))))}
        grid = JaxMesh(np.asarray(jax.devices("cpu")[:4]).reshape(2, 2),
                       ("data", "model"))
        ref["jax_tp"] = np.asarray(jtp.TPWaveGlowServer(
            tmodel, {"params": tparams}, grid, fused=True)(
            jnp.asarray(tspect), None, TP_SIGMA,
            noise=tuple(jnp.asarray(z) for z in tnoise)))
        wg = convert.load_waveglow({"params": lparams}, lcfg)
        kw = dict(sigma=SIGMA, chunk_frames=CHUNK, overlap_frames=OVERLAP,
                  noise=inputs["long_noise"])
        ref["long"] = {
            "plain": chunked.infer_long(wg, inputs["long_spect"], **kw),
            "fused": chunked.infer_long(prepare_fused(wg, torch.float32),
                                        inputs["long_spect"], **kw),
            "int8": chunked.infer_long(prepare_fused_int8(wg, torch.float32),
                                       inputs["long_spect"], **kw)}
        tpm = convert.load_waveglow({"params": tparams}, tcfg)
        ref["tp"] = {}
        for name, kw in (("plain", dict(fused=False)),
                         ("fused", dict(compute_dtype=torch.float32)),
                         ("int8", dict(int8=True,
                                       compute_dtype=torch.float32))):
            ref["tp"][name] = ttp.TPWaveGlowServer(tpm, 2, **kw)(
                inputs["tp_spect"], TP_SIGMA, noise=inputs["tp_noise"])
        ref["tp"]["generator"] = ttp.TPWaveGlowServer(
            tpm, 2, compute_dtype=torch.float32)(
            inputs["tp_spect"], TP_SIGMA,
            generator=torch.Generator().manual_seed(5))
        ref["tp"]["infer"] = tpm.infer(inputs["tp_spect"], TP_SIGMA,
                                       noise=inputs["tp_noise"])
        trainer = waveglow_train.main(cli + ["--output_directory",
                                             str(tmp / "one_out"),
                                             "--num_steps", "2"])
        ref["cli"] = {n: p.detach().clone()
                      for n, p in trainer.model.params.items()}
        taco = tacotron_train.main(_taco_cli(tmp, "one"))
        ref["taco_cli"] = {
            "loss": float(taco.last_metrics["loss"]),
            "sd": {n: t.clone() for n, t in taco.model.state_dict().items()}}
        logs = []
        for pr in procs:
            out, _ = pr.communicate(timeout=150)
            logs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait(timeout=10)
    assert [pr.returncode for pr in procs] == [0] * 4, "\n".join(logs)
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(4)]
    return ranks, ref, tmp, logs


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def test_meshes_and_their_groups(run):
    """Row-major layout: rank r sits at (r // 2, r % 2) of the 2 x 2 grid;
    each axis' group sums exactly the ranks of its line."""
    ranks = run[0]
    for r, res in enumerate(ranks):
        flat, coords, gshape, gcoords, d6, d6_member, pair_member = \
            res["shapes"]
        assert (flat, coords, gshape) == ((4,), (r,), (2, 2))
        assert gcoords == (r // 2, r % 2)
        assert d6 == (3,) and d6_member == (r < 3)
        assert pair_member == (r < 2)
        assert res["sums"] == {"flat": 6.0,
                               "grid_data": float(r % 2 + (r % 2 + 2)),
                               "grid_model": float(2 * (r // 2) * 2 + 1)}


def test_a_rank_outside_the_data_mesh_is_told(run):
    ranks = run[0]
    assert [res["outside"] is None for res in ranks] == [True] * 3 + [False]
    msg = ranks[3]["outside"]
    assert "rank 3 is outside the data mesh" in msg
    assert "batch 6" in msg and "3 of the 4 ranks" in msg


def test_shard_gather_replicate_and_mean(run):
    ranks = run[0]
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    for r, res in enumerate(ranks):
        assert torch.equal(res["shard"], x[2 * r:2 * r + 2])
        assert torch.equal(res["gathered"], 2 * x)
        # rank 0's weights (0) and bias (10), and its Adam moments (0)
        assert res["replicated"] == ([0.0, 20.0], [0.0, 0.0])
        assert res["means"] == [[1.5, 1.0], 3.0]


def test_infer_long_over_a_two_rank_data_mesh(run):
    """7 windows padded to 8: each of the two member ranks vocodes 4 and
    returns the whole utterance."""
    ranks, ref = run[0], run[1]
    assert "long" not in ranks[2] and "long" not in ranks[3]
    for r in range(2):
        got = ranks[r]["long"]
        assert got["plain"].shape == (1, FRAMES * LONG["upsample_stride"])
        np.testing.assert_allclose(got["plain"].numpy(), ref["jax_long"],
                                   atol=1e-5, rtol=0)
        for kind in ("plain", "fused", "int8"):
            assert _max_diff(got[kind], ref["long"][kind]) < 1e-6, kind


def test_tp_grid_matches_jax_and_the_one_process_servers(run):
    """Every rank of the 2 x 2 grid returns the whole batch."""
    ranks, ref = run[0], run[1]
    for r in range(4):
        got = ranks[r]["tp"]
        assert got["fused"].shape == (TP_B, TP_FRAMES * 16)
        np.testing.assert_allclose(got["fused"].numpy(), ref["jax_tp"],
                                   atol=3e-4)
        for kind in ("plain", "fused", "int8", "generator"):
            assert _max_diff(got[kind], ref["tp"][kind]) < 1e-6, (r, kind)
        np.testing.assert_allclose(got["plain"].numpy(),
                                   ref["tp"]["infer"].numpy(), atol=2e-4)


def test_training_cli_on_a_world_larger_than_its_data_mesh(run):
    """Batch 2 on 4 ranks: ranks 0-1 train data-parallel (rank 0 alone
    writes; one checkpoint; a resume on both), equal to the one-process
    run; ranks 2-3 refuse, naming the batch and the world."""
    ranks, ref, tmp, logs = run
    assert [ranks[r]["cli"]["mesh"] for r in range(2)] == [(2,), (2,)]
    assert [ranks[r]["cli"]["writer"] for r in range(2)] == [True, False]
    assert ranks[0]["cli"]["steps"] == ranks[1]["cli"]["steps"] == [2]
    assert [ranks[r]["cli"]["resumed"] for r in range(2)] == [
        (3, [2, 3])] * 2
    assert sorted(os.listdir(tmp / "dp_out")) == [
        "ckpt_00000002.pt", "ckpt_00000003.pt", "tb"]
    for n, p in ref["cli"].items():
        assert _max_diff(ranks[0]["cli"]["params"][n], p) < 1e-6, n
        assert torch.equal(ranks[0]["cli"]["params"][n],
                           ranks[1]["cli"]["params"][n])
    for r in (2, 3):
        assert f"rank {r} is outside the data mesh: batch 2" in \
            ranks[r]["cli"]
        assert "2 of the 4 ranks" in ranks[r]["cli"]
    assert "distributed: process 0/4 (gloo, cpu)" in logs[0]


def test_tacotron_cli_on_a_world_larger_than_its_data_mesh(run):
    """``tacotron_train.main`` with batch 2 on 4 ranks: one run directory
    (rank 0's, named by its clock), a data mesh of ranks 0-1, rank 0 alone
    writing the checkpoints, the one-process run's loss (``rel=1e-6``),
    parameters and running statistics (``< 1e-6``); ranks 2-3 refuse."""
    ranks, ref, tmp, _ = run
    a, b = ranks[0]["taco_cli"], ranks[1]["taco_cli"]
    assert a["run_dir"] == b["run_dir"]
    assert os.listdir(tmp / "dp") == [os.path.basename(a["run_dir"])]
    assert (a["mesh"], b["mesh"]) == ((2,), (2,))
    assert (a["writer"], b["writer"]) == (True, False)
    assert a["steps"] == b["steps"] == [1, 2]
    assert sorted(os.listdir(a["run_dir"])) == [
        "checkpoints", "params.json", "tb", "train.log"]
    assert a["loss"] == b["loss"] == pytest.approx(ref["taco_cli"]["loss"],
                                                   rel=1e-6)
    for n, t in ref["taco_cli"]["sd"].items():
        assert _max_diff(a["sd"][n], t) < 1e-6, n
        assert torch.equal(a["sd"][n], b["sd"][n]), n
    for r in (2, 3):
        assert f"rank {r} is outside the data mesh: batch 2" in \
            ranks[r]["taco_cli"]
