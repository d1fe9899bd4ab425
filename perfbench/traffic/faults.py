"""Faults planted under a run by the tests of ``correct``: each breaks the
timed path the way a wrong change could, and the run's check must then
come out false.  Nothing here runs in a benchmark run.

* ``answer``: the vocoder's output altered where it is produced (each
  call's last 32 mel frames of audio zeroed);
* ``state``: a decoder step that returns its state unchanged;
* ``train_state``: a training step that leaves the parameters as they
  were;
* ``half_batch``: the loss over the first half of each rank's rows, the
  mean taken over the rest;
* ``no_exchange``: the gradient all-reduce between the ranks left out;
* ``gradient``: one leaf's gradient altered before the update."""

from __future__ import annotations


def plant(fault: str, synth=None, train=None):
    """Break the run's objects (or, for ``no_exchange``, the trainer's
    module); returns the undo of a change that outlives the run's objects,
    or None."""
    if fault == "answer":
        vocoder = synth.vocoder
        infer = vocoder.infer
        hop32 = 32 * synth.wg_cfg.upsample_stride

        def altered(*a, **kw):
            audio = infer(*a, **kw).clone()
            audio[:, -hop32:] = 0.0
            return audio

        vocoder.infer = altered
    elif fault == "state":
        dec = synth.taco.decoder
        step = dec.step

        def frozen(state, *a, **kw):
            _, out = step(state, *a, **kw)
            return state, out

        dec.step = frozen
    elif fault == "train_state":
        train["state"].apply_gradients = lambda: None
    elif fault == "half_batch":
        model = train["model"]
        forward = model.forward

        def half(spect, audio):
            n = max(1, spect.shape[0] // 2)
            return forward(spect[:n], audio[:n])

        model.forward = half
    elif fault == "no_exchange":
        import text2speech_tpu_torch.train.waveglow as twg

        exchange = twg.all_reduce_mean_
        twg.all_reduce_mean_ = lambda tensors, mesh, axis="data": None

        def undo():
            twg.all_reduce_mean_ = exchange

        return undo
    elif fault == "gradient":
        state = train["state"]
        apply = state.apply_gradients
        first = next(iter(state.params.values()))

        def altered():
            first.grad.mul_(1.5)
            apply()

        state.apply_gradients = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return None
