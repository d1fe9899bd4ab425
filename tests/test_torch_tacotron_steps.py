"""Tacotron-2 optimizer steps in the port against the JAX package's:
three steps of ``make_train_step`` against ``create_train_state`` /
``make_train_step`` with the masks JAX drew, and ``grad_accum=2`` against
hand-rolled microbatches.  The fixture, the mask replay and the tolerances
are those of ``tests/test_torch_tacotron_train.py`` (a file of its own so
that the two spread over the test workers)."""

import jax
import numpy as np
import pytest
import torch

from text2speech_tpu.train.state import create_train_state
from text2speech_tpu.train.tacotron import make_train_step as jax_make_step
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.data.dataset import Batch
from text2speech_tpu_torch.models.losses import tacotron2_loss
from text2speech_tpu_torch.train.state import create_tacotron_state
from text2speech_tpu_torch.train.tacotron import make_train_step

from tests.test_torch_tacotron_train import (B, HP, JHP, LR_SCALE, SPEAKERS,
                                             T_IN, T_OUT, _feeds_batchnorm,
                                             _jax_model, _port, _torch_batch,
                                             jax_value_and_grad, setup)

torch.set_num_threads(1)
assert setup  # the shared module-scoped fixture


def test_three_train_steps_track_jax(setup):
    """Three optimizer steps (clip by global norm 0.5, coupled L2, Adam,
    Noam at warmup 2) against ``create_train_state`` / ``make_train_step``,
    each step's masks those JAX drew from ``fold_in(PRNGKey(0), step)``."""
    b, jb, variables = setup
    jmodel = _jax_model()
    jstate = create_train_state(JHP, variables)
    jstep = jax.jit(jax_make_step(jmodel, JHP))
    model = _port(variables)
    state = create_tacotron_state(model, HP)
    step = make_train_step(model, HP)
    tb = _torch_batch(b)
    base = jax.random.PRNGKey(0)
    for i in range(3):
        rng = jax.random.fold_in(base, i)
        cur = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        *_, masks = jax_value_and_grad(jmodel, cur, jb, rng)
        jstate, jm = jstep(jstate, jb, rng)
        state, tm = step(state, tb, masks=masks)
        assert state.step == i + 1 == int(jstate.step)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        assert float(jm["grad_norm"]) > HP.grad_clip_norm   # clipping on
    want = convert.flatten_tree({"params": jstate.params,
                                 "batch_stats": jstate.batch_stats})
    start = convert.flatten_tree(variables)
    sd = model.state_dict()
    moved = 0.0
    for dst, src, kind in convert.tacotron_layout(HP, SPEAKERS):
        w = convert.to_port_layout(want[src], kind)
        diff = float((sd[dst] - w).abs().max())
        if _feeds_batchnorm(dst):
            # Adam turns the rounding noise of a zero gradient into steps
            # of about lr either way on both sides: bounded, not equal
            assert diff <= 2 * 3 * LR_SCALE, dst
        elif src.startswith("params/"):
            assert diff < 0.02 * LR_SCALE, (dst, diff / LR_SCALE)
            moved = max(moved, float((sd[dst] - convert.to_port_layout(
                start[src], kind)).abs().max()))
        elif dst.endswith("running_mean"):
            # the batch mean carries the conv bias before it
            assert diff <= 2 * 3 * LR_SCALE, dst
        else:
            assert diff < 1e-5, dst
    assert moved > LR_SCALE      # three steps of about lr each


def test_grad_accum_matches_manual_microbatches(setup):
    """``grad_accum=2`` is the hand-rolled reference: strided halves, each
    normalized by its own statistics, the running statistics threaded
    through them in order, gradients at the same parameters averaged, one
    update (``test_train_infra.py:111``): 1e-6."""
    b, jb, variables = setup
    tb = _torch_batch(b)
    probe = _port(variables)
    masks = [probe.draw_train_masks(B // 2, T_IN, T_OUT,
                                    torch.Generator().manual_seed(10 + i))
             for i in range(2)]
    model = _port(variables)
    state = create_tacotron_state(model, HP)
    _, metrics = make_train_step(model, HP, grad_accum=2)(state, tb,
                                                          masks=masks)

    ref = _port(variables)
    ref_state = create_tacotron_state(ref, HP)
    halves = [Batch(*(x[i::2] for x in tb)) for i in range(2)]
    losses = []
    for mb, m in zip(halves, masks):
        outs = ref(mb.text, mb.input_lengths, mb.mel, mb.output_lengths,
                   speaker_ids=mb.speaker_id, train=True, masks=m)
        loss, _ = tacotron2_loss(*outs[:3], mb.mel, mb.gate)
        loss.backward()
        losses.append(float(loss))
    for p in ref.parameters():
        p.grad /= 2
    ref_state.apply_gradients()
    assert float(metrics["loss"]) == pytest.approx(np.mean(losses),
                                                   rel=1e-6)
    got, want = model.state_dict(), ref.state_dict()
    for name, t in want.items():
        assert float((got[name].float() - t.float()).abs().max()) < 1e-6, \
            name
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(model, HP, grad_accum=3)(state, tb)
