"""The port's tensor-parallel vocoder (``text2speech_tpu_torch.parallel.tp``)
against the JAX package's (``text2speech_tpu.parallel.tp`` on the virtual
CPU mesh, its Pallas kernels in interpret mode) given the same weights, mel
and noise, and against the port's own single-device vocoders.

The local form (one process holds all ``n_model`` shards) is the
counterpart of the JAX mesh; the distributed form (one rank per process,
gloo) must equal it.  Tolerances are stated at each comparison."""

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
from jax.sharding import Mesh

from text2speech_tpu.config import WaveGlowConfig as JaxWaveGlowConfig
from text2speech_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from text2speech_tpu.parallel import tp as jtp
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.models.waveglow_fused import (infer_fused,
                                                         infer_fused_int8,
                                                         prepare_fused,
                                                         prepare_fused_int8)
from text2speech_tpu_torch.parallel import tp as ttp

torch.set_num_threads(1)

WG_KW = dict(n_mel_channels=16, n_flows=4, n_group=8, n_early_every=2,
             n_early_size=2, wn_n_layers=3, wn_n_channels=32,
             wn_kernel_size=3, upsample_kernel=64, upsample_stride=16)
CFG = WaveGlowConfig(**WG_KW)
B, FRAMES = 2, 24
GPF = CFG.upsample_stride // CFG.n_group


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def models():
    """The JAX WaveGlow with every parameter perturbed (the zero-init end
    convs would hide the WN stacks) and the port's on the same weights."""
    jcfg = JaxWaveGlowConfig(**WG_KW)
    jmodel = JaxWaveGlow(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, CFG.n_mel_channels, 20)),
                            jnp.zeros((1, 20 * CFG.upsample_stride)))
    rng = np.random.RandomState(1)
    variables = {"params": jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * rng.randn(*x.shape).astype(
            np.float32), variables["params"])}
    return jcfg, jmodel, variables, convert.load_waveglow(variables, CFG)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    spect = rng.randn(B, CFG.n_mel_channels, FRAMES).astype(np.float32)
    noise = tuple(rng.randn(*s).astype(np.float32)
                  for s in ttp.noise_shapes(CFG, B, FRAMES * GPF))
    return spect, noise


def _torch_in(inputs):
    spect, noise = inputs
    return torch.from_numpy(spect), tuple(torch.from_numpy(z) for z in noise)


def _jax_server(models, n_model: int, **kw):
    jcfg, jmodel, variables, _ = models
    mesh = Mesh(np.asarray(jax.devices("cpu")[:n_model]), ("model",))
    return jtp.TPWaveGlowServer(jmodel, variables, mesh, data_axis=None, **kw)


# --- the shards ------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4])
def test_shards_match_jax(models, p):
    """Same slices, leaf by leaf.  The port folds weight norm when it
    loads, in numpy; the JAX function folds in its own f32 order: 1e-6."""
    jcfg, _, variables, tmodel = models
    want = jtp.shard_waveglow_params(variables["params"], jcfg, p)
    got = ttp.shard_waveglow_params(tmodel, p)
    assert got["wn0"]["in0"]["w"].shape == (p, 3, 32, 64 // p)
    assert got["wn0"]["rs0"]["w"].shape == (p, 32 // p, 64)
    assert got["wn0"]["rs2"]["w"].shape == (p, 32 // p, 32)
    for k in range(CFG.n_flows):
        np.testing.assert_allclose(got[f"convinv{k}"].numpy(),
                                   np.asarray(want[f"convinv{k}"]["W"]))
        jb, tb = want[f"wn{k}"], got[f"wn{k}"]
        assert set(jb) == set(tb)
        for name, leaf in jb.items():
            if isinstance(leaf, dict):
                for sub, arr in leaf.items():
                    np.testing.assert_allclose(
                        tb[name][sub].numpy(), np.asarray(arr), atol=1e-6,
                        err_msg=f"wn{k}/{name}/{sub}")
            else:
                np.testing.assert_allclose(tb[name].numpy(), np.asarray(leaf),
                                           atol=1e-6, err_msg=name)


def test_int8_shards_match_jax(models):
    """Per-rank quantization: payloads within one count of the JAX shards'
    (a folded weight that differs in its last bit can cross a rounding
    edge), scales to 1e-6 relative; layer 0 stays floating point."""
    jcfg, _, variables, tmodel = models
    want = jtp.shard_waveglow_params(variables["params"], jcfg, 2, int8=True)
    got = ttp.shard_waveglow_params(tmodel, 2, int8=True)
    blk_j, blk_t = want["wn1"], got["wn1"]
    assert set(blk_t["in0"]) == {"w", "b"}
    for name in ("in1", "cond2", "rs1", "rs2"):
        assert set(blk_t[name]) == {"q", "s", "b"}
        assert blk_t[name]["q"].dtype == torch.int8
        dq = np.abs(blk_t[name]["q"].numpy().astype(np.int32)
                    - np.asarray(blk_j[name]["q"]).astype(np.int32))
        assert dq.max() <= 1 and dq.mean() < 1e-3, (name, dq.max())
        np.testing.assert_allclose(blk_t[name]["s"].numpy(),
                                   np.asarray(blk_j[name]["s"]), rtol=1e-6)
        np.testing.assert_allclose(blk_t[name]["b"].numpy(),
                                   np.asarray(blk_j[name]["b"]), atol=1e-6)
    # the res/skip bias is kept whole, the in/cond biases are cut
    assert blk_t["rs1"]["b"].shape == (64,)
    assert blk_t["in1"]["b"].shape == (2, 32)


def test_ranks_argument_cuts_one_shard(models):
    tmodel = models[3]
    full = ttp.shard_waveglow_params(tmodel, 4)
    one = ttp.shard_waveglow_params(tmodel, 4, ranks=[2])
    assert one["wn3"]["in1"]["w"].shape[0] == 1
    assert torch.equal(one["wn3"]["in1"]["w"][0], full["wn3"]["in1"]["w"][2])
    assert torch.equal(one["wn3"]["end"]["w"][0], full["wn3"]["end"]["w"][2])
    with pytest.raises(ValueError, match="does not split"):
        ttp.shard_waveglow_params(tmodel, 3)


# --- the local form against the JAX mesh and the single device -------------


def test_plain_tp_matches_jax_and_single_device(models, inputs):
    """``fused=False``: f32 throughout.  Against the port's own
    ``WaveGlow.infer`` only the order of the res/skip sum differs (2e-4
    absolute, the JAX test's bound); against the JAX server likewise."""
    tmodel = models[3]
    spect, noise = _torch_in(inputs)
    ref = tmodel.infer(spect, 0.8, noise=noise)
    want = np.asarray(_jax_server(models, 4, fused=False)(
        jnp.asarray(inputs[0]), None, 0.8,
        noise=tuple(jnp.asarray(z) for z in inputs[1])))
    for p in (2, 4):
        got = ttp.TPWaveGlowServer(tmodel, p, fused=False)(spect, 0.8,
                                                           noise=noise)
        assert got.shape == ref.shape == (B, FRAMES * CFG.upsample_stride)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    one_shot = ttp.infer_waveglow_tp(tmodel, spect, 0.8, n_model=2,
                                     noise=noise)
    np.testing.assert_allclose(one_shot.numpy(), ref.numpy(), atol=2e-4)


def test_fused_tp_matches_jax_and_infer_fused(models, inputs):
    """``fused=True`` in f32 (the plain partials here, the Pallas partials
    in interpret mode there): 3e-4 absolute against the JAX server and
    against the port's single-device ``infer_fused`` in f32, the JAX
    test's bound for the same pair."""
    tmodel = models[3]
    spect, noise = _torch_in(inputs)
    want = np.asarray(_jax_server(models, 2, fused=True)(
        jnp.asarray(inputs[0]), None, 0.8,
        noise=tuple(jnp.asarray(z) for z in inputs[1])))
    single = infer_fused(prepare_fused(tmodel, torch.float32), spect, 0.8,
                         noise=noise)
    for p in (2, 4):
        got = ttp.TPWaveGlowServer(tmodel, p, fused=True,
                                   compute_dtype=torch.float32)(
            spect, 0.8, noise=noise)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4)
        np.testing.assert_allclose(got.numpy(), single.numpy(), atol=3e-4)


def test_int8_tp_tracks_jax_and_f32(models, inputs):
    """int8 TP: within the JAX test's band of the f32 reference (5x the
    single-device int8 error, at least 0.05 relative L2), and as close to
    the JAX int8 server as that is to f32 (knife-edge payload flips make
    the two int8 paths differ by quantization noise, not by more)."""
    tmodel = models[3]
    spect, noise = _torch_in(inputs)
    ref = tmodel.infer(spect, 0.8, noise=noise).numpy()
    sd = infer_fused_int8(prepare_fused_int8(tmodel, torch.float32), spect,
                          0.8, noise=noise).numpy()
    err_sd = rel_l2(sd, ref)
    want = np.asarray(_jax_server(models, 2, fused=True, int8=True)(
        jnp.asarray(inputs[0]), None, 0.8,
        noise=tuple(jnp.asarray(z) for z in inputs[1])))
    band = max(5 * err_sd, 0.05)
    assert rel_l2(want, ref) < band
    for p in (2, 4):
        got = ttp.TPWaveGlowServer(tmodel, p, int8=True,
                                   compute_dtype=torch.float32)(
            spect, 0.8, noise=noise).numpy()
        assert rel_l2(got, ref) < band, (p, rel_l2(got, ref), err_sd)
        if p == 2:
            assert rel_l2(got, want) < band, rel_l2(got, want)


def test_fused_tp_zeroes_the_hidden_tail(models):
    """``_wn_tp_fused`` with ``n_valid < T``: the valid rows equal the call
    at the exact length, whatever the tail of the inputs holds beyond the
    zero the caller leaves there."""
    tmodel = models[3]
    p, L = 2, CFG.wn_n_layers
    params = ttp.shard_waveglow_params(tmodel, p)
    blk = params["wn0"]
    shards = ttp.prepare_fused_shards(blk, L, torch.float32, False)
    g = torch.Generator().manual_seed(3)
    T, nv = 40, 29
    n_half = blk["start_k"].shape[0]
    x0 = torch.randn(1, T, n_half, generator=g)
    cond = torch.randn(1, T, CFG.n_mel_channels * CFG.n_group, generator=g)
    x0[:, nv:] = 0
    cond[:, nv:] = 0
    args = (L, [0, 1], p, None)
    full = ttp._wn_tp_fused(blk, shards, x0, cond, *args, nv, torch.float32)
    exact = ttp._wn_tp_fused(blk, shards, x0[:, :nv].contiguous(),
                             cond[:, :nv].contiguous(), *args, nv,
                             torch.float32)
    np.testing.assert_allclose(full[:, :nv].numpy(), exact.numpy(), atol=1e-5)


def test_server_arguments_are_checked(models):
    tmodel = models[3]
    with pytest.raises(ValueError, match="n_model or a process group"):
        ttp.TPWaveGlowServer(tmodel)
    with pytest.raises(ValueError, match="fused partial kernels"):
        ttp.TPWaveGlowServer(tmodel, 2, fused=False, int8=True)
    server = ttp.TPWaveGlowServer(tmodel, 2, fused=False)
    with pytest.raises(ValueError, match="noise draw"):
        server(torch.zeros(1, 16, 8), noise=(torch.zeros(1, 3, 4),))
    # a generator in place of explicit noise: seeded alike, equal audio
    a = server(torch.zeros(1, 16, 8), generator=torch.Generator().manual_seed(5))
    b = server(torch.zeros(1, 16, 8), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


# --- the distributed form ---------------------------------------------------

_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.infer import random_weights_
from text2speech_tpu_torch.models.waveglow import WaveGlow
from text2speech_tpu_torch.parallel.tp import TPWaveGlowServer

port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
try:
    cfg = WaveGlowConfig(**%(cfg)r)
    model = WaveGlow(cfg)
    random_weights_(model, torch.Generator().manual_seed(0), out_first=False)
    with torch.no_grad():
        for wn in model.wn:
            wn.end_w.mul_(0.05)
    g = torch.Generator().manual_seed(1)
    spect = torch.randn(2, cfg.n_mel_channels, 12, generator=g)
    res = {}
    for name, kw in (("plain", dict(fused=False)),
                     ("fused", dict(compute_dtype=torch.float32)),
                     ("int8", dict(int8=True, compute_dtype=torch.float32))):
        server = TPWaveGlowServer(model, group=dist.group.WORLD, **kw)
        assert server.ranks == [rank] and server.n_model == 2
        res[name] = server(spect, 0.7,
                           generator=torch.Generator().manual_seed(2)).numpy()
    np.savez(out, **res)
    # rank 0 hosts the TCP store: no rank tears it down while the other
    # may still be using it
    dist.barrier()
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group_equals_the_local_form(tmp_path):
    """Two processes, one rank each, all-reduce over gloo: every rank's
    audio equals the local two-shard form's bit for bit (a two-term sum is
    the same in either order).  The processes are killed after 150 s."""
    from text2speech_tpu_torch.infer import random_weights_
    from text2speech_tpu_torch.models.waveglow import WaveGlow

    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(_WORKER % {"cfg": WG_KW}))
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(r),
         str(tmp_path / f"out{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=150)
            logs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait(timeout=10)
    assert [pr.returncode for pr in procs] == [0, 0], "\n".join(logs)

    model = WaveGlow(CFG)
    random_weights_(model, torch.Generator().manual_seed(0), out_first=False)
    with torch.no_grad():
        for wn in model.wn:
            wn.end_w.mul_(0.05)
    g = torch.Generator().manual_seed(1)
    spect = torch.randn(2, CFG.n_mel_channels, 12, generator=g)
    for name, kw in (("plain", dict(fused=False)),
                     ("fused", dict(compute_dtype=torch.float32)),
                     ("int8", dict(int8=True, compute_dtype=torch.float32))):
        local = ttp.TPWaveGlowServer(model, 2, **kw)(
            spect, 0.7, generator=torch.Generator().manual_seed(2)).numpy()
        assert np.isfinite(local).all()
        for r in range(2):
            got = np.load(tmp_path / f"out{r}.npz")[name]
            np.testing.assert_array_equal(got, local, err_msg=f"{name} {r}")
