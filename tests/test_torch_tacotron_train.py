"""Tacotron-2 training in the port (the teacher-forced forward,
``tacotron2_loss``, the schedule and the clip) against the JAX package's on
the same numpy batch and converted weights, with the dropout masks JAX
drew; the optimizer steps are in ``tests/test_torch_tacotron_steps.py``.

The masks: the decoder's key is what ``Tacotron2.derive_rng`` returns
(``tacotron2.py:514``: flax counts each scope's ``make_rng`` calls apart,
so the encoder's dropouts do not move it); :func:`jax_decoder_masks`
replays ``teacher_forced``'s splits (``:329-333``), the prenet's (``:93-95``)
and ``step``'s (``:278, 285, 301``).  The encoder's and the postnet's
``nn.Dropout`` masks come from ``capture_intermediates``: keep = output !=
0 (an encoder output that is zero because its ReLU was off gets the same
value and the same zero gradient either way).

Config: a tiny HParams (two encoder convs, three postnet convs, widths 8
and 16), two speakers, a batch of four rows of unequal text and mel
lengths, so the masking of ``mask_outputs``, the attention mask and the
speaker conditioning all take part.  JAX initialises the parameters; every
leaf is then perturbed by 0.05 N(0, 1) so that no gradient leaf is
degenerate.

Tolerances.  f32: both sides do the same f32 products in another order
through 16 decoder steps whose attention and LSTM state feed back: the
loss within 1e-5 relative (measured 1.4e-7), each gradient leaf within
2e-5 of the leaf's largest entry (measured: at most 5.1e-6), the running
statistics within 1e-6.  A conv bias that feeds a BatchNorm has a zero
gradient in exact arithmetic (the normalization takes any per-channel
constant back out); both sides return rounding noise there, so those
leaves are held to 1e-5 of the largest gradient entry of the model
(measured 6e-7).  After optimizer steps parameters are compared in units
of ``lr`` (Adam's update is about ``lr`` whatever the gradient's size):
0.02 ``lr`` over three steps.  bf16: products of bf16-rounded operands
(2^-8 each) with the LSTM gates, tanh and sigmoid in bf16 on both sides
but rounded at other places (flax rounds each Dense output, autocast each
product): loss within 1e-3 relative (measured 4.1e-4), the gradient as a
whole within 0.05 relative L2 (measured 0.023), each leaf but the
BatchNorm-fed conv biases within 0.1 (measured at most 0.076)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.data.dataset import Batch as JaxBatch
from text2speech_tpu.models.losses import tacotron2_loss as jax_loss
from text2speech_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from text2speech_tpu.text import N_SYMBOLS
from text2speech_tpu.train.state import noam_schedule as jax_noam
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams
from text2speech_tpu_torch.data.dataset import Batch
from text2speech_tpu_torch.models.losses import tacotron2_loss
from text2speech_tpu_torch.models.tacotron2 import TrainMasks
from text2speech_tpu_torch.train.state import (clip_by_global_norm_,
                                               noam_schedule)

torch.set_num_threads(1)

TINY = dict(
    embedding_size=16, enc_conv_num_layers=2, enc_conv_channels=16,
    attention_rnn_dim=16, decoder_rnn_dim=16, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=7,
    prenet_dim=8, n_mel_channels=8, postnet_embedding_dim=8,
    postnet_n_convolutions=3, learning_rate=1e-3, warmup_steps=2,
    grad_clip_norm=0.5,
)
HP, JHP = HParams(**TINY), JaxHParams(**TINY)
SPEAKERS = 2
B, T_IN, T_OUT = 4, 12, 16
LR_SCALE = 1e-3     # the schedule's largest rate over three steps


def _batch() -> JaxBatch:
    rng = np.random.RandomState(0)
    in_len = np.asarray([12, 10, 8, 5], np.int32)
    out_len = np.asarray([16, 14, 11, 7], np.int32)
    text = rng.randint(2, 70, (B, T_IN)).astype(np.int32)
    text[np.arange(T_IN)[None, :] >= in_len[:, None]] = 0
    mel = rng.randn(B, HP.n_mel_channels, T_OUT).astype(np.float32)
    mel[:, :, :] *= (np.arange(T_OUT)[None, :] < out_len[:, None])[:, None]
    gate = (np.arange(T_OUT)[None, :] >= out_len[:, None] - 1).astype(
        np.float32)
    return JaxBatch(text, in_len, mel, gate,
                    np.asarray([0, 1, 0, 1], np.int32), out_len)


def _torch_batch(b: JaxBatch) -> Batch:
    return Batch(*(torch.from_numpy(np.asarray(x)) for x in b))


@pytest.fixture(scope="module")
def setup():
    b = _batch()
    jb = JaxBatch(*map(jnp.asarray, b))
    rng = jax.random.PRNGKey(0)
    model = JaxTacotron2(JHP, n_vocab=N_SYMBOLS, num_speakers=SPEAKERS)
    variables = jax.jit(model.init)(
        {"params": rng, "dropout": rng}, jb.text, jb.input_lengths, jb.mel,
        jb.output_lengths, speaker_ids=jb.speaker_id)
    leaves, tree = jax.tree.flatten(variables["params"])
    prng = np.random.RandomState(1)
    leaves = [x + 0.05 * prng.randn(*x.shape).astype(np.float32)
              for x in leaves]
    variables = {"params": jax.tree.unflatten(tree, leaves),
                 "batch_stats": variables["batch_stats"]}
    return b, jb, variables


def _jax_model(dtype=None, remat=False):
    return JaxTacotron2(JHP, n_vocab=N_SYMBOLS, num_speakers=SPEAKERS,
                        compute_dtype=dtype, decoder_remat=remat)


def _is_dropout(mdl, _method):
    return isinstance(mdl, nn.Dropout)


def jax_decoder_masks(model, variables, rng, batch: int, t_out: int):
    """The prenet, attention and decoder keep-masks of ``model.__call__``
    under ``rngs={"dropout": rng}``, replayed from its key schedule."""
    base = model.apply(variables, method=JaxTacotron2.derive_rng,
                       rngs={"dropout": rng})
    rng_pre, rng_steps = jax.random.split(base)
    prenet = []
    for _ in range(2):
        rng_pre, sub = jax.random.split(rng_pre)
        prenet.append(jax.random.bernoulli(
            sub, 0.5, (batch, t_out, JHP.prenet_dim)))
    att, dec = [], []
    for key in jax.random.split(rng_steps, t_out):
        k_att, k_dec = jax.random.split(key)
        att.append(jax.random.bernoulli(k_att, 1 - JHP.p_attention_dropout,
                                        (batch, JHP.attention_rnn_dim)))
        dec.append(jax.random.bernoulli(k_dec, 1 - JHP.p_decoder_dropout,
                                        (batch, JHP.decoder_rnn_dim)))
    def as_t(xs):
        return torch.from_numpy(np.array(jnp.stack(xs)))

    return as_t(prenet), as_t(att), as_t(dec)


_JITTED = {}


def _jitted_value_and_grad(model):
    """One compiled value-and-grad per model (compute dtype)."""
    if model.compute_dtype not in _JITTED:
        def loss_fn(params, stats, jb, rng):
            outs, mut = model.apply(
                {"params": params, "batch_stats": stats}, jb.text,
                jb.input_lengths, jb.mel, jb.output_lengths,
                speaker_ids=jb.speaker_id, train=True, rngs={"dropout": rng},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=_is_dropout)
            loss, _ = jax_loss(*outs[:3], jb.mel, jb.gate)
            return loss, mut

        _JITTED[model.compute_dtype] = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))
    return _JITTED[model.compute_dtype]


def jax_value_and_grad(model, variables, jb, rng):
    """(loss, grads, new batch_stats, TrainMasks) of one JAX training
    forward."""
    (loss, mut), grads = _jitted_value_and_grad(model)(
        variables["params"], variables["batch_stats"], jb, rng)
    inter = mut["intermediates"]

    def keeps(scope, n):
        return [torch.from_numpy(np.asarray(
            inter[scope][f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(n)]

    prenet, att, dec = jax_decoder_masks(model, variables, rng,
                                         jb.text.shape[0], jb.mel.shape[-1])
    masks = TrainMasks(keeps("encoder", JHP.enc_conv_num_layers), prenet,
                       att, dec, keeps("postnet", JHP.postnet_n_convolutions))
    return float(loss), grads, mut["batch_stats"], masks


def _port(variables, **kw):
    return convert.trainable_tacotron_from_variables(
        variables, HP, N_SYMBOLS, SPEAKERS, **kw)


def _port_value_and_grad(model, tb, masks):
    outs = model(tb.text, tb.input_lengths, tb.mel, tb.output_lengths,
                 speaker_ids=tb.speaker_id, train=True, masks=masks)
    loss, _ = tacotron2_loss(*outs[:3], tb.mel, tb.gate)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def _leaves(tree_flat: dict, sd: dict) -> list:
    """(name, port tensor, JAX leaf in the port's layout) of every flax
    leaf in ``tree_flat`` (flat ``params/...`` or ``batch_stats/...``
    keys)."""
    out = []
    for dst, src, kind in convert.tacotron_layout(HP, SPEAKERS):
        if src in tree_flat:
            out.append((dst, sd[dst],
                        convert.to_port_layout(tree_flat[src], kind)))
    return out


def _feeds_batchnorm(name: str) -> bool:
    """A conv bias right before a BatchNorm: zero gradient in exact
    arithmetic."""
    return re.fullmatch(r"(encoder|postnet)\.convs\.\d+\.bias", name) \
        is not None


def test_f32_loss_grads_and_statistics_match_jax(setup):
    b, jb, variables = setup
    rng = jax.random.PRNGKey(7)
    loss_j, grads_j, stats_j, masks = jax_value_and_grad(
        _jax_model(), variables, jb, rng)
    model = _port(variables)
    loss_t, grads_t = _port_value_and_grad(model, _torch_batch(b), masks)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-5)
    leaves = _leaves(convert.flatten_tree({"params": grads_j}), grads_t)
    assert len(leaves) == len(grads_t)
    gmax = max(float(w.abs().max()) for _, _, w in leaves)
    for name, g, want in leaves:
        err = float((g - want).abs().max())
        if _feeds_batchnorm(name):
            assert err <= 1e-5 * gmax, name
        else:
            assert err <= 2e-5 * float(want.abs().max()), name
    stats = _leaves(convert.flatten_tree({"batch_stats": stats_j}),
                    model.state_dict())
    assert len(stats) == 2 * (HP.enc_conv_num_layers
                              + HP.postnet_n_convolutions)
    before = _port(variables).state_dict()
    for name, s, want in stats:
        np.testing.assert_allclose(s.numpy(), want.numpy(), atol=1e-6,
                                   err_msg=name)
        assert not torch.allclose(s, before[name]), name   # they moved


def test_bf16_loss_and_grads_track_jax(setup):
    b, jb, variables = setup
    rng = jax.random.PRNGKey(8)
    loss_j, grads_j, _, masks = jax_value_and_grad(
        _jax_model(jnp.bfloat16), variables, jb, rng)
    model = _port(variables, compute_dtype=torch.bfloat16)
    loss_t, grads_t = _port_value_and_grad(model, _torch_batch(b), masks)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-3)
    leaves = _leaves(convert.flatten_tree({"params": grads_j}), grads_t)
    got = torch.cat([g.flatten() for _, g, _ in leaves])
    want = torch.cat([w.flatten() for _, _, w in leaves])
    assert float((got - want).norm() / want.norm()) < 0.05
    for name, g, w in leaves:
        if not _feeds_batchnorm(name):
            assert float((g - w).norm() / w.norm()) < 0.1, name
    assert all(g.dtype == torch.float32 for g in grads_t.values())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_remat_equals_plain(setup, dtype):
    """Recomputing each decoder step in the backward pass replays the same
    operations on the same values: bit-equal loss and gradients, also in
    bf16 (each step casts the weights afresh, so no cast is shared between
    the steps of one run and not the other's)."""
    b, jb, variables = setup
    tb = _torch_batch(b)
    model = _port(variables)
    masks = model.draw_train_masks(B, T_IN, T_OUT,
                                   torch.Generator().manual_seed(3))
    out = []
    for remat in (False, True):
        model = _port(variables, decoder_remat=remat, compute_dtype=dtype)
        out.append(_port_value_and_grad(model, tb, masks))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(g, out[1][1][name]), name


@pytest.mark.parametrize("init_lr,warmup", [(1e-3, 4000), (1e-4, 2)])
def test_noam_schedule_matches_optax(init_lr, warmup):
    sched, jsched = noam_schedule(init_lr, warmup), jax_noam(init_lr, warmup)
    for s in (0, 1, 2, 10, warmup - 1, warmup, 5 * warmup, 100000):
        assert sched(s) == pytest.approx(float(jsched(jnp.asarray(s))),
                                         rel=1e-6)


def test_clip_by_global_norm_is_optax_s():
    import optax

    g = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    norm = clip_by_global_norm_(g, 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray([3.0, 0.0]), jnp.asarray([[4.0]])], None)
    assert float(norm) == 5.0
    for a, w in zip(g, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-7)
    small = [torch.tensor([0.1])]
    clip_by_global_norm_(small, 1.0)
    assert float(small[0]) == pytest.approx(0.1)
