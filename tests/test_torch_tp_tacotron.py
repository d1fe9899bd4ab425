"""The port's tensor-parallel Tacotron decode
(``text2speech_tpu_torch.parallel.tp_tacotron``) against the JAX package's
(``text2speech_tpu.parallel.tp_tacotron`` on the virtual CPU mesh) given the
same weights and prenet masks, and against the port's single-device
serving decode (``models.tacotron_serve.decode_chunk_serve``).

In this process: ``_gate_cols`` and the shards against the JAX functions,
the one-process decode (all ``p`` shards here) at p = 1, 2, 4, 8 against
JAX ``TPTacotronDecoder`` on ``Mesh(cpu[:p])`` and against the port's
``decode_chunk_serve`` (mel, gate, alignment, carry and frame within the
JAX test's 1e-5, ``tests/test_tp_tacotron.py:130-143``; active and
finished equal), a carry chained over two chunks, and int8 tracking
floating point in the JAX package's band.

Four processes, one rank each over gloo (spawned once for the file, killed
after 150 s), run a 2 x 2 (data x model) grid: the decode over each data
line's model group of 2, bit-equal to the one-process two-shard decode,
and the decode over the grid, each data rank its row, bit-equal to the
one-process decode of that row."""

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

from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.models import tacotron_serve as jserve
from text2speech_tpu.models.tacotron2 import DecoderState as JaxDecoderState
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.parallel import tp_tacotron as jtp
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams
from text2speech_tpu_torch.models import tacotron_serve as tserve
from text2speech_tpu_torch.models.tacotron2 import DecoderState
from text2speech_tpu_torch.parallel import tp_tacotron as ttp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP_KW = dict(
    sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=24,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, max_decoder_steps=20)
HP = HParams(**HP_KW)
B, T_IN, STEPS = 2, 12, 10
TOL = 1e-5


def jax_masks(rngs, batch: int) -> torch.Tensor:
    """The keep-masks ``decode_chunk_serve`` draws from shared step keys:
    per step a prenet/step split, per prenet layer a split and
    ``bernoulli(0.5)`` over [B, prenet_dim] -> bool [n, 2, B, prenet]."""
    masks = []
    for rng_t in rngs:
        rng_pre, _ = jax.random.split(rng_t)
        layers = []
        for _ in range(2):
            rng_pre, sub = jax.random.split(rng_pre)
            layers.append(np.asarray(jax.random.bernoulli(
                sub, 0.5, (batch, HP.prenet_dim))))
        masks.append(np.stack(layers))
    return torch.from_numpy(np.stack(masks))


@pytest.fixture(scope="module")
def setup():
    """The JAX Tacotron and the port's on the same weights, the gate bias
    raised by 0.006 so that the first row stops at its first step (gate
    0.0035 there) and the second never does (gates below -0.005); memory,
    processed memory and masks on both sides."""
    jhp = JaxHParams(**HP_KW)
    rng = jax.random.PRNGKey(0)
    model = JaxTacotron2(jhp, n_vocab=N_SYMBOLS)
    text = np.random.RandomState(0).randint(2, 70, (B, T_IN)).astype(np.int32)
    lengths = np.asarray([12, 9], np.int32)
    variables = model.init(
        {"params": rng, "dropout": rng}, jnp.asarray(text),
        jnp.asarray(lengths), jnp.zeros((B, HP.n_mel_channels, 8)),
        jnp.asarray([8, 8]))
    variables = jax.tree.map(np.array, variables)
    variables["params"]["decoder"]["gate_proj"]["bias"] += 0.006
    jmem = model.apply(variables, jnp.asarray(text),
                       text_lengths=jnp.asarray(lengths),
                       method=JaxTacotron2.encode)
    jpmem = model.apply(
        variables, jmem,
        method=lambda m, mem: m.decoder.attention.process_memory(mem))
    rngs = jax.random.split(jax.random.PRNGKey(7), STEPS)
    taco = convert.load_tacotron(variables, HP, N_SYMBOLS)
    return dict(variables=variables, jhp=jhp, jmem=jmem, jpmem=jpmem,
                rngs=rngs, lengths=lengths, taco=taco,
                masks=jax_masks(rngs, B),
                tmem=torch.from_numpy(np.array(jmem)),
                tpmem=torch.from_numpy(np.array(jpmem)))


def jax_carry(batch=B):
    def z(*s):
        return jnp.zeros(s, jnp.float32)

    return (JaxDecoderState(z(batch, 16), z(batch, 16), z(batch, 24),
                            z(batch, 24), z(batch, T_IN), z(batch, T_IN),
                            z(batch, 16)),
            z(batch, HP.n_mel_channels), jnp.zeros((batch,), bool))


def port_decode(s, decoder=None, masks=None):
    """The port's decode of the fixture's batch: through ``decoder`` (a
    TPTacotronDecoder) or, without it, ``decode_chunk_serve``."""
    masks = s["masks"] if masks is None else masks
    carry = s["taco"].decoder.initial_carry(s["tmem"])
    lengths = torch.from_numpy(s["lengths"]).long()
    with torch.no_grad():
        if decoder is None:
            return tserve.decode_chunk_serve(
                tserve.extract_decoder_params(s["taco"]), HP, s["tmem"],
                s["tpmem"], *carry, masks, lengths)
        return decoder(s["tmem"], s["tpmem"], *carry, masks, lengths)


def assert_decodes_agree(got, want, what):
    """Mel, gate, alignment, every carry leaf and the frame within TOL;
    active and finished equal."""
    (st_g, fr_g, fin_g), *outs_g = got
    (st_w, fr_w, fin_w), *outs_w = want
    for name, g, w in zip(("mel", "gate", "align"), outs_g[:3], outs_w[:3]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL,
                                   err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(np.asarray(outs_g[3]),
                                  np.asarray(outs_w[3]))
    np.testing.assert_array_equal(np.asarray(fin_g), np.asarray(fin_w))
    np.testing.assert_allclose(np.asarray(fr_g), np.asarray(fr_w), atol=TOL)
    for field, g, w in zip(DecoderState._fields, st_g, st_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL,
                                   err_msg=f"{what}: carry {field}")


# --- the shards ---------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_gate_cols_match_jax(p):
    for H in (16, 24, 1024):
        if H % p:
            continue
        for i in range(p):
            np.testing.assert_array_equal(ttp._gate_cols(H, p, i),
                                          jtp._gate_cols(H, p, i))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_shards_match_jax(setup, p):
    """The port's row slices are the JAX package's column slices,
    transposed, bit for bit; the other weights are the same tensors."""
    jdp = jserve.extract_decoder_params(setup["variables"], setup["jhp"])
    want = jax.tree.map(np.asarray, jtp.shard_decoder_params(
        jdp, setup["jhp"], p))
    dp = tserve.extract_decoder_params(setup["taco"])
    got = ttp.shard_decoder_params(dp, HP, p)
    for wk, bk, dim in ttp._LSTM_KEYS:
        H = getattr(HP, dim)
        assert got[wk].shape == (p, 4 * H // p, dp[wk].shape[1])
        np.testing.assert_array_equal(got[wk].numpy(),
                                      want[wk].transpose(0, 2, 1))
        np.testing.assert_array_equal(got[bk].numpy(), want[bk])
    assert got["query_w"] is dp["query_w"]
    one = ttp.shard_decoder_params(dp, HP, p, ranks=[p - 1])
    assert torch.equal(one["dec_hh_w"][0], got["dec_hh_w"][p - 1])
    with pytest.raises(ValueError, match="does not split"):
        ttp.shard_decoder_params(dp, HP, 5)


@pytest.mark.parametrize("p", [2, 8])
def test_int8_shards_match_jax_and_the_whole_kernels_scales(setup, p):
    """int8 slices: payloads and scales equal to the JAX slices', and each
    slice's scales equal to the rows of the whole kernel's (slicing keeps
    each output channel's amax)."""
    jdp = jserve.extract_decoder_params(setup["variables"], setup["jhp"])
    want = jax.tree.map(np.asarray, jtp.shard_decoder_params(
        jdp, setup["jhp"], p, int8=True))
    dp = tserve.extract_decoder_params(setup["taco"])
    got = ttp.shard_decoder_params(dp, HP, p, int8=True)
    whole = tserve.quantize_decoder_params(dp, min_elems=1)
    for wk, _, dim in ttp._LSTM_KEYS:
        H = getattr(HP, dim)
        assert got[wk]["q"].dtype == torch.int8
        np.testing.assert_array_equal(got[wk]["q"].numpy(),
                                      want[wk]["q"].transpose(0, 2, 1))
        np.testing.assert_array_equal(got[wk]["s"].numpy(), want[wk]["s"])
        for i in range(p):
            rows = torch.from_numpy(ttp._gate_cols(H, p, i))
            assert torch.equal(got[wk]["s"][i], whole[wk]["s"][rows])
            assert torch.equal(got[wk]["q"][i], whole[wk]["q"][rows])


# --- the one-process decode ---------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_tp_decode_matches_jax_and_the_serving_decode(setup, p):
    s = setup
    mesh = Mesh(np.asarray(jax.devices("cpu")[:p]), ("model",))
    jdec = jtp.TPTacotronDecoder(
        jserve.extract_decoder_params(s["variables"], s["jhp"]), s["jhp"],
        mesh, data_axis=None)
    want = jdec(s["jmem"], s["jpmem"], *jax_carry(), s["rngs"],
                jnp.asarray(s["lengths"]))
    dec = ttp.TPTacotronDecoder(s["taco"], HP, n_model=p)
    assert dec.ranks == list(range(p)) and dec.group is None
    got = port_decode(s, dec)
    assert_decodes_agree(got, want, f"p={p} vs JAX")
    assert_decodes_agree(got, port_decode(s), f"p={p} vs decode_chunk_serve")
    # the regime is exercised: one row stops, the other does not
    assert got[0][2].tolist() == [True, False]


def test_carry_chains_over_two_chunks(setup):
    """A returned carry feeds the next call: two chunks of 5 steps equal
    one chunk of 10, and the serving decode."""
    s = setup
    dec = ttp.TPTacotronDecoder(s["taco"], HP, n_model=4)
    lengths = torch.from_numpy(s["lengths"]).long()
    carry = dec.initial_carry(s["tmem"])
    assert carry[0].attention_c.shape == (B, 16)
    mels = []
    for half in (s["masks"][:5], s["masks"][5:]):
        carry, mel, *_ = dec(s["tmem"], s["tpmem"], *carry, half, lengths)
        mels.append(mel)
    whole = port_decode(s)
    torch.testing.assert_close(torch.cat(mels, -1), whole[1], atol=TOL,
                               rtol=0)
    for g, w in zip(carry[0], whole[0][0]):
        torch.testing.assert_close(g, w, atol=TOL, rtol=0)


def test_int8_tracks_fp_and_jax(setup):
    """int8 slices against floating point: mean error over the mean
    magnitude under 0.2, the JAX package's band
    (``tests/test_tp_tacotron.py:174-193``).  Against the JAX int8 TP
    decode: integer products exact on both sides, float32 sums around them
    in another order, which can move an activation payload by a count that
    the recurrence carries on: 5e-3 over 10 steps, the bound of the port's
    single-device int8 decode against the JAX one."""
    s = setup
    mesh = Mesh(np.asarray(jax.devices("cpu")[:2]), ("model",))
    jdec = jtp.TPTacotronDecoder(
        jserve.extract_decoder_params(s["variables"], s["jhp"]), s["jhp"],
        mesh, data_axis=None, int8=True)
    _, jmel, *_ = jdec(s["jmem"], s["jpmem"], *jax_carry(), s["rngs"],
                       jnp.asarray(s["lengths"]))
    dec = ttp.TPTacotronDecoder(s["taco"], HP, n_model=2, int8=True)
    _, mel_q, *_ = port_decode(s, dec)
    _, mel_fp, *_ = port_decode(s)
    assert torch.isfinite(mel_q).all()
    err = (mel_q - mel_fp).abs().mean() / (mel_fp.abs().mean() + 1e-6)
    assert 0 < err < 0.2, err
    np.testing.assert_allclose(mel_q.numpy(), np.asarray(jmel), atol=5e-3)


def test_bf16_decode_runs(setup):
    """``dtype=torch.bfloat16``: the weights are cast once, the carry
    comes back in bf16 and feeds the next call, the mel in f32."""
    s = setup
    dec = ttp.TPTacotronDecoder(s["taco"], HP, n_model=2,
                                dtype=torch.bfloat16)
    assert dec._shards[1]["att_ih_w"].dtype == torch.bfloat16
    (st, fr, fin), mel, *_ = port_decode(s, dec)
    assert mel.dtype == torch.float32 and torch.isfinite(mel).all()
    assert st.attention_c.dtype == torch.bfloat16
    lengths = torch.from_numpy(s["lengths"]).long()
    with torch.no_grad():
        (_, _, _), mel2, *_ = dec(s["tmem"], s["tpmem"], st, fr, fin,
                                  s["masks"][:2], lengths)
    assert torch.isfinite(mel2).all()
    _, mel_fp, *_ = port_decode(s)
    err = (mel - mel_fp).abs().mean() / mel_fp.abs().mean()
    assert err < 0.05, err


# --- four processes -----------------------------------------------------------

_WORKER = """
import sys
import torch
from text2speech_tpu_torch.config import HParams
from text2speech_tpu_torch.models.tacotron2 import Tacotron2
from text2speech_tpu_torch.parallel import mesh as pm
from text2speech_tpu_torch.parallel.tp_tacotron import TPTacotronDecoder

port, rank, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
assert pm.initialize_distributed(f"tcp://localhost:{port}", 4, rank,
                                 device="cpu")
try:
    d = torch.load(inp, weights_only=False)
    hp = HParams(**d["hp"])
    taco = Tacotron2(hp, d["n_vocab"])
    taco.load_state_dict(d["sd"])
    grid = pm.make_mesh((2, 2), (pm.DATA_AXIS, pm.MODEL_AXIS))
    res = {"coords": grid.coords}
    mem, pmem, masks, lengths = d["mem"], d["pmem"], d["masks"], d["lengths"]

    def run(dec, n):
        carry = dec.initial_carry(mem)
        outs = []
        for half in (masks[:n], masks[n:]):
            carry, *o = dec(mem, pmem, *carry, half, lengths)
            outs.append(o)
        return carry, outs

    # the model group of this rank's data line: the whole batch
    dec = TPTacotronDecoder(taco, hp, group=grid.group(pm.MODEL_AXIS))
    res["group"] = {"ranks": dec.ranks, "n_model": dec.n_model,
                    "run": run(dec, 5)}
    # the grid: this data rank's row, gathered back
    dec = TPTacotronDecoder(taco, hp, mesh=grid)
    res["grid"] = {"ranks": dec.ranks, "run": run(dec, 5),
                   "n_model": dec.n_model}
    torch.save(res, out)
finally:
    pm.destroy_distributed()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_local(dec, mem, pmem, masks, lengths):
    carry = dec.initial_carry(mem)
    outs = []
    with torch.no_grad():
        for half in (masks[:5], masks[5:]):
            carry, *o = dec(mem, pmem, *carry, half, lengths)
            outs.append(o)
    return carry, outs


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    s = setup
    tmp = tmp_path_factory.mktemp("tp_taco")
    lengths = torch.from_numpy(s["lengths"]).long()
    inputs = {"hp": HP_KW, "n_vocab": N_SYMBOLS,
              "sd": s["taco"].state_dict(), "mem": s["tmem"],
              "pmem": s["tpmem"], "masks": s["masks"], "lengths": lengths}
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
        # the references meanwhile: the one-process two-shard decode of the
        # batch and of each row
        two = ttp.TPTacotronDecoder(s["taco"], HP, n_model=2)
        ref = {"batch": _run_local(two, s["tmem"], s["tpmem"], s["masks"],
                                   lengths),
               "rows": [_run_local(two, s["tmem"][r:r + 1],
                                   s["tpmem"][r:r + 1],
                                   s["masks"][:, :, r:r + 1],
                                   lengths[r:r + 1]) for r in range(B)]}
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
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(4)], ref


def _assert_runs_equal(got, want, cols=None):
    """Both chunks' outputs and the final carry bit for bit; ``cols``
    (start, width) picks this rank's columns of the reference's cell
    states."""
    (c_g, outs_g), (c_w, outs_w) = got, want
    for og, ow in zip(outs_g, outs_w):
        for a, b in zip(og, ow):
            assert torch.equal(a, b)
    (st_g, fr_g, fin_g), (st_w, fr_w, fin_w) = c_g, c_w
    assert torch.equal(fr_g, fr_w) and torch.equal(fin_g, fin_w)
    for field, a, b in zip(DecoderState._fields, st_g, st_w):
        if cols is not None and field.endswith("_c"):
            k = b.shape[-1] // 2
            b = b[:, cols * k:(cols + 1) * k]
        assert torch.equal(a, b), field


def test_two_rank_model_group_equals_one_process(ranks):
    """Each data line's model group of 2 decodes the whole batch: every
    output bit-equal to the one-process two-shard decode (the column gather
    adds zeros), the cell states the rank's half of its columns."""
    res, ref = ranks
    for r in range(4):
        g = res[r]["group"]
        assert g["ranks"] == [r % 2] and g["n_model"] == 2
        _assert_runs_equal(g["run"], ref["batch"], cols=r % 2)


def test_data_by_model_grid_equals_the_row_blocks(ranks, setup):
    """On the 2 x 2 grid a data rank decodes its row and the outputs are
    gathered: every rank returns the batch, each row bit-equal to the
    one-process decode of that row, and the batch within TOL of the
    one-process decode of the batch."""
    res, ref = ranks
    for r in range(4):
        g = res[r]["grid"]
        assert g["ranks"] == [r % 2] and g["n_model"] == 2
        (st, fr, fin), outs = g["run"]
        for row in range(B):
            (st_w, fr_w, fin_w), outs_w = ref["rows"][row]
            for og, ow in zip(outs, outs_w):
                for a, b in zip(og, ow):
                    assert torch.equal(a[row:row + 1], b)
            assert torch.equal(fr[row:row + 1], fr_w)
            assert torch.equal(fin[row:row + 1], fin_w)
            for field, a, b in zip(DecoderState._fields, st, st_w):
                if field.endswith("_c"):
                    k = b.shape[-1] // 2
                    b = b[:, (r % 2) * k:(r % 2 + 1) * k]
                assert torch.equal(a[row:row + 1], b), field
        for og, ow in zip(outs, ref["batch"][1]):
            for a, b in zip(og, ow):
                torch.testing.assert_close(a.float(), b.float(), atol=TOL,
                                           rtol=0)
