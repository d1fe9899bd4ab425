"""The port's spans and counters (``utils/profiling.py``: ``annotate``,
``count``, ``recording``) at its layer boundaries, on the CPU at tiny
widths.

* With no recorder installed, ``annotate`` hands out one shared null
  context, records nothing and reads no clock.
* Under ``recording()``: the offline path's spans (text, encoder, decoder,
  postnet, the blocking reads, the vocoder's upsample and flows, the
  denoiser) and set-up spans (the reference loaders of ``convert.py``,
  ``Synthesizer``'s derived weights) nest strictly, each span's parent is
  the innermost span around it, ``taco.decoder_steps`` adds each call's
  steps, and the outputs are bit-equal with the recorder on and off; a
  one-process data-parallel WaveGlow step records its five ``train.*``
  spans and the bytes it all-reduces; ``ContinuousBatcher.step`` records
  its ``serve.*`` spans, and its frame counters equal the windows and
  chunks the scheduler ran.
* The recorder's clock is ``time.perf_counter``, and a span is also a
  ``record_function`` region under a ``torch.profiler``."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.examples.reference_checkpoints import (
    reference_tacotron_state_dict, reference_waveglow_state_dict)
from text2speech_tpu_torch.infer import Synthesizer
from text2speech_tpu_torch.server import ContinuousBatcher
from text2speech_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = HParams(
    sample_rate=22050, embedding_size=16, enc_conv_num_layers=1,
    enc_conv_channels=16, attention_rnn_dim=16, decoder_rnn_dim=16,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=8, n_mel_channels=8,
    postnet_embedding_dim=8, postnet_n_convolutions=2, max_decoder_steps=40)
WG = WaveGlowConfig(
    n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2, n_early_size=2,
    wn_n_layers=3, wn_n_channels=16, upsample_kernel=64, upsample_stride=16,
    sampling_rate=22050, hop_length=16)
DEN_KW = dict(filter_length=64, n_overlap=4, win_length=64, n_frames=12)
TEXTS = ["안녕하세요.", "존경하는 사람과 함께 갑니다.", "네."]
OFFLINE_SPANS = ("synth.text", "taco.encoder", "taco.decoder",
                 "taco.postnet", "synth.read_lengths", "wg.upsample",
                 "wg.flows", "synth.denoiser", "synth.read_audio")
SETUP_SPANS = ("convert.tacotron", "convert.waveglow", "synth.derive")
TRAIN_SPANS = ("train.shard", "train.optimizer", "train.forward",
               "train.backward", "train.allreduce", "train.optimizer")
SERVE_SPANS = ("serve.admit", "serve.decode", "serve.read",
               "serve.postnet", "serve.vocode", "serve.denoise")


def build_synth() -> Synthesizer:
    """The benchmark's route: reference-layout state dicts through
    ``convert.py``'s module loaders into a fused, denoising
    ``Synthesizer``."""
    taco = convert.tacotron_module_from_torch(
        reference_tacotron_state_dict(HP, 3), HP)
    wg = convert.waveglow_module_from_torch(
        reference_waveglow_state_dict(WG, 4), WG)
    return Synthesizer(HP, taco, WG, wg, use_fused_vocoder=True,
                       denoiser_kwargs=DEN_KW)


def synthesize(synth, max_steps):
    return synth.synthesize(TEXTS, seed=5, denoiser_strength=0.1,
                            max_steps=max_steps)


def check_nesting(spans) -> None:
    """Spans of one thread nest strictly, and each span's parent is the
    innermost span that encloses it (None when none does)."""
    by_id = {s[4]: s for s in spans}
    for a in spans:
        for b in spans:
            if a is b:
                continue
            disjoint = a[2] <= b[1] or b[2] <= a[1]
            a_in_b = b[1] <= a[1] and a[2] <= b[2]
            b_in_a = a[1] <= b[1] and b[2] <= a[2]
            assert disjoint or a_in_b or b_in_a, (a, b)
    for s in spans:
        around = [o for o in spans if o is not s and o[1] <= s[1]
                  and s[2] <= o[2] and o[4] < s[4]]
        inner = max(around, key=lambda o: o[1]) if around else None
        assert s[3] == (None if inner is None else inner[4]), s
        if s[3] is not None:
            assert by_id[s[3]] is inner


def test_no_recorder_costs_one_check(monkeypatch):
    """Without a recorder or a profiler: the same null object every time,
    nothing recorded, and no clock read, in the API and through a whole
    ``synthesize`` call."""
    def no_clock():
        raise AssertionError("the clock was read with tracing off")

    synth = build_synth()
    assert profiling._RECORDER is None
    monkeypatch.setattr(time, "perf_counter", no_clock)
    a, b = profiling.annotate("taco.decoder"), profiling.annotate("wg.flows")
    assert a is b is profiling._NULL
    with a:
        with b:
            profiling.count("taco.decoder_steps", 3)
    assert len(synthesize(synth, 24)) == len(TEXTS)
    assert profiling._RECORDER is None


def test_the_recorder_clock_is_perf_counter(monkeypatch):
    ticks = iter(range(100, 200))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    with profiling.recording() as rec:
        with profiling.annotate("outer"):
            profiling.count("n", 7)
            with profiling.annotate("inner"):
                pass
    assert rec.spans == [("inner", 102.0, 103.0, 0, 1),
                         ("outer", 100.0, 104.0, None, 0)]
    assert rec.counters == {"n": [(101.0, 7)]}
    assert profiling._RECORDER is None


def test_a_span_is_a_profiler_region_too(tmp_path):
    with profiling.recording() as rec:
        with profiling.trace_capture(str(tmp_path)) as path:
            with profiling.annotate("wg.flows"):
                torch.randn(16, 16) @ torch.randn(16, 16)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "wg.flows" in names
    assert [s[0] for s in rec.spans] == ["wg.flows"]


def test_offline_spans_nest_and_leave_the_outputs_alone():
    """Set-up and two ``synthesize`` calls under one recorder: every
    layer's span, strictly nested; the decoder's counter adds each call's
    steps; the audio bit-equal to the same calls with tracing off."""
    off_synth = build_synth()
    off = [synthesize(off_synth, m) for m in (24, 40)]
    with profiling.recording() as rec:
        synth = build_synth()
        set_up = len(rec.spans)
        on = [synthesize(synth, m) for m in (24, 40)]
    names = [s[0] for s in rec.spans]
    assert set(names[:set_up]) == set(SETUP_SPANS)
    for name in OFFLINE_SPANS:
        assert names[set_up:].count(name) == 2, name
    check_nesting(rec.spans)
    by_id = {s[4]: s for s in rec.spans}
    # the reference loaders: convert.* around the flax-layout loaders
    nested = [s for s in rec.spans if s[3] is not None]
    assert nested and all(s[0].startswith("convert.")
                          and by_id[s[3]][0] == s[0] for s in nested)
    assert [v for _, v in rec.counters["taco.decoder_steps"]] == [24, 40]
    assert set(rec.counters) == {"taco.decoder_steps"}
    for a, b in zip(off, on):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


_TRAIN = """
import json, sys
import torch
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import WaveGlowConfig
from text2speech_tpu_torch.data.mel2samp import VocoderBatch
from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
from text2speech_tpu_torch.parallel import mesh as pm
from text2speech_tpu_torch.train.state import create_train_state
from text2speech_tpu_torch.train.waveglow import make_wg_train_step
from text2speech_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)
cfg = WaveGlowConfig(**json.loads(sys.argv[2]))
assert pm.initialize_distributed(f"tcp://localhost:{sys.argv[1]}", 1, 0,
                                 device="cpu")
try:
    mesh = pm.make_data_mesh(4)
    model = TrainableWaveGlow(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model.params, cfg.learning_rate)
    step = make_wg_train_step(model, cfg.sigma, mesh=mesh)
    g = torch.Generator().manual_seed(1)
    frames = cfg.segment_length // cfg.upsample_stride
    batch = VocoderBatch(
        torch.randn((4, cfg.n_mel_channels, frames), generator=g),
        0.3 * torch.randn((4, cfg.segment_length), generator=g))
    with recording() as rec:
        _, m = step(state, batch)
    grads = sum(p.grad.numel() * p.grad.element_size()
                for p in state.params.values())
    print(json.dumps({
        "spans": [s[0] for s in rec.spans],
        "bytes": [v for _, v in rec.counters["train.allreduce_bytes"]],
        "want": grads + m["loss"].numel() * m["loss"].element_size()}))
finally:
    pm.destroy_distributed()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_a_data_parallel_train_step_records_its_spans_and_bytes():
    """A one-rank gloo group on the CPU, as the data-parallel tests build
    theirs: the five ``train.*`` spans in order (the optimizer's twice:
    dropping the last gradients, then the update), and
    ``train.allreduce_bytes`` the gradient and loss buffers' bytes."""
    cfg = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
               n_early_size=2, wn_n_layers=2, wn_n_channels=16,
               upsample_kernel=32, upsample_stride=8, segment_length=512,
               learning_rate=1e-3, sigma=0.9)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_TRAIN), str(_free_port()),
         json.dumps(cfg)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["spans"] == list(TRAIN_SPANS)
    assert res["bytes"] == [res["want"]]


def toy_server(slots: int, stop: dict, masked: bool = False, cs: int = 4,
               requested: int = 16):
    """A ``ContinuousBatcher`` over exact toy callables (the scheduler
    tests' toy: decode frame values from the request id, a gate after
    ``stop[uid]`` frames, zero postnet residual, a local vocoder), with
    every vocoder call's width recorded in ``srv.widths``."""
    prf = ov = 1
    limit = -(-requested // cs) * cs
    widths = []

    def decode_fn(batch, masks):
        n = masks.shape[0]
        steps = batch["t0"][:, None] + torch.arange(n)[None, :]
        mel = (batch["uid"][:, None, None] * 1000.0 + steps[:, None, :]
               + torch.arange(2)[None, :, None] / 10.0)
        active = (steps <= batch["stop"][:, None]) & ~batch["done"][:, None]
        done = batch["done"] | (steps[:, -1] >= batch["stop"])
        return dict(batch, t0=batch["t0"] + n, done=done), mel, active, done

    def vocode_fn(mel, noise, sigma):
        widths.append(mel.shape[-1])
        return (mel[:, 0, :].repeat_interleave(2, dim=-1)
                + noise[0][..., 0].repeat_interleave(2, dim=-1))

    def masked_fn(mel, noise, sigma, length):
        return vocode_fn(mel, noise, sigma)

    srv = ContinuousBatcher(
        slots=slots, chunk_steps=cs, requested=requested, prf=prf, ov=ov,
        n_mel=2, gpf=1, hop=2, noise_widths=(1,), sigma=1.0, device="cpu",
        admit_fn=lambda uid, seed: {
            "uid": torch.tensor(float(uid)), "t0": torch.tensor(0.0),
            "stop": torch.tensor(float(stop[uid])),
            "done": torch.tensor(False)},
        init_batch_fn=lambda: {
            "uid": torch.zeros(slots), "t0": torch.zeros(slots),
            "stop": torch.zeros(slots) + 10_000.0,
            "done": torch.zeros(slots, dtype=torch.bool)},
        decode_fn=decode_fn, postnet_fn=torch.zeros_like,
        vocode_fn=vocode_fn, vocode_masked_fn=masked_fn if masked else None,
        key_fn=lambda seed: torch.zeros((limit, 2, 1), dtype=torch.bool),
        noise_fn=lambda seed: lambda j: (np.zeros((cs, 1), np.float32),),
        retain_sessions=True)
    srv.widths = widths
    return srv


@pytest.mark.parametrize("masked", [False, True])
def test_serve_spans_and_frame_counts(masked):
    """One slot, so that each vocoder call holds one real window: frames
    vocoded are the calls' widths (a short session's masked pass runs the
    fixed width), frames emitted each session's true length; the round's
    spans, one ``serve.decode`` a round."""
    stop = {0: 2, 1: 99, 2: 11}
    srv = toy_server(1, stop, masked)
    with profiling.recording() as rec:
        wavs = srv.run([0, 1, 2])
    lengths = [min(stop[u] + 1, srv.requested) for u in (0, 1, 2)]
    assert [len(wavs[i]) for i in range(3)] == [n * srv.hop for n in lengths]
    st = srv.stats
    assert st["frames_emitted"] == sum(lengths)
    assert st["frames_emitted"] * srv.hop == st["emitted_samples"]
    assert st["frames_vocoded"] == sum(srv.widths)
    assert st["frames_vocoded"] > st["frames_emitted"]
    assert len(srv.widths) == st["vocoder_calls"]
    assert not rec.counters
    names = [s[0] for s in rec.spans]
    assert set(names) == set(SERVE_SPANS)
    assert names.count("serve.decode") == st["rounds"]
    assert names.count("serve.admit") == st["rounds"]
    check_nesting(rec.spans)


def test_frames_vocoded_count_real_windows_only():
    """A session alone in two slots: its vocoder batches are padded with
    copies of a window, and its flush windows share one call.  Neither
    changes the count: the same frames as in one slot."""
    one, two = toy_server(1, {0: 99}), toy_server(2, {0: 99})
    one.run([0])
    two.run([0])
    assert len(two.widths) < len(one.widths)
    assert (two.stats["frames_vocoded"] == one.stats["frames_vocoded"]
            == sum(one.widths))
    assert (two.stats["frames_emitted"] == one.stats["frames_emitted"]
            == one.requested)
