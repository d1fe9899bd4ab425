"""The port's quality, profiling and logging tools against the JAX
package's: ``utils/quality.py`` (its own numpy copy: equal results on the
same arrays), ``utils/profiling.py`` on the CPU (a Chrome trace that names
an ``annotate`` region; ``StepTimer``'s contract), ``utils/logger.py``'s
``log_validation`` (the same image tags, steps and pixels as the JAX
logger's through a recording stand-in for ``SummaryWriter``; one histogram
per parameter of the port) and both ``close`` methods; and a Tacotron
trainer that validates where neither matplotlib nor tensorboardX can be
imported, as on the card's machine."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text2speech_tpu.utils import logger as jlogger
from text2speech_tpu.utils import quality as jquality
from text2speech_tpu_torch.utils import profiling, quality
from text2speech_tpu_torch.utils.logger import MetricsLogger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _align(seed, B, T, K, peaky):
    rng = np.random.RandomState(seed)
    a = rng.rand(B, T, K).astype(np.float32)
    if peaky:
        a = a ** 6
    return a / a.sum(-1, keepdims=True)


ALIGN_CASES = {
    "diagonal": lambda: (np.eye(12, dtype=np.float32)[None].repeat(2, 0),
                         np.asarray([12, 12]), np.asarray([12, 12]), 1),
    "uniform": lambda: (np.full((2, 24, 12), 1 / 12, np.float32),
                        np.asarray([12, 9]), np.asarray([24, 20]), 1),
    "random_ragged": lambda: (_align(0, 3, 30, 10, False),
                              np.asarray([10, 7, 4]),
                              np.asarray([30, 21, 1]), 1),
    "peaky_band2": lambda: (_align(1, 2, 20, 10, True),
                            np.asarray([10, 8]), np.asarray([20, 16]), 2),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_alignment_diagonality_equals_jax(case):
    align, in_len, out_len, band = ALIGN_CASES[case]()
    got = quality.alignment_diagonality(align, in_len, out_len, band=band)
    assert got == jquality.alignment_diagonality(align, in_len, out_len,
                                                 band=band)


MEL_CASES = {
    "identity": lambda m, o: (m, m, np.asarray([30, 25])),
    "noise": lambda m, o: (o, m, np.asarray([30, 25])),
    "affine": lambda m, o: (3.5 * m - 2.0, m, np.asarray([30, 25])),
    "empty_row": lambda m, o: (o, m, np.asarray([0, 12])),
    "all_empty": lambda m, o: (o, m, np.asarray([0, 0])),
}


@pytest.mark.parametrize("case", sorted(MEL_CASES))
def test_mel_fidelity_and_standardize_equal_jax(case):
    rng = np.random.RandomState(2)
    mel = rng.randn(2, 8, 30).astype(np.float32)
    other = rng.randn(2, 8, 30).astype(np.float32)
    pred, tgt, lengths = MEL_CASES[case](mel, other)
    assert quality.mel_fidelity(pred, tgt, lengths) == \
        jquality.mel_fidelity(pred, tgt, lengths)
    assert np.array_equal(quality.standardize_mel(pred),
                          jquality.standardize_mel(pred))


def test_trace_capture_names_the_region(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace_capture(str(tmp_path / "prof")) as path:
        with profiling.annotate("port_region"):
            y = x @ x
    assert y.shape == (64, 64)
    assert os.path.dirname(path) == str(tmp_path / "prof")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "port_region" in names
    # a second capture writes a file of its own
    with profiling.trace_capture(str(tmp_path / "prof")) as path2:
        pass
    assert path2 != path and os.path.exists(path2)


def test_step_timer_contract(monkeypatch):
    """``last_host`` is the block's wall time; ``last_device`` is set only
    when the block registered an output, and is at least ``last_host``.
    CPU tensors, however nested, synchronize no device."""
    def no_sync(*_):
        raise AssertionError("synchronized a device for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timer = profiling.StepTimer()
    assert timer.last_host == timer.last_device == 0.0
    with timer.step():
        sum(range(1000))
    assert timer.last_host > 0 and timer.last_device == 0.0
    with timer.step() as t:
        out = {"a": [torch.ones(3), (torch.zeros(2), 1)], "b": None}
        t.block_on(out)
    assert timer.last_device >= timer.last_host > 0


class Recorder:
    """A recording stand-in for ``tensorboardX.SummaryWriter``."""

    def __init__(self, logdir=None):
        self.calls = []
        self.closed = 0

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), step))

    def add_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, np.asarray(values), step))

    def add_image(self, tag, image, step, dataformats="CHW"):
        self.calls.append(("image", tag, np.asarray(image), step,
                           dataformats))

    def close(self):
        self.closed += 1


def test_log_validation_writes_the_jax_loggers_images(tmp_path,
                                                      monkeypatch):
    import tensorboardX

    monkeypatch.setattr(tensorboardX, "SummaryWriter", Recorder)
    monkeypatch.setattr(jlogger, "SummaryWriter", Recorder)
    rng = np.random.RandomState(0)
    B, M, T, TIN = 2, 8, 12, 6
    mel_t = rng.randn(B, M, T).astype(np.float32)
    gate_t = (np.arange(T)[None] >= T - 2).repeat(B, 0).astype(np.float32)
    preds = [rng.randn(B, M, T).astype(np.float32),
             rng.randn(B, M, T).astype(np.float32),
             rng.randn(B, T).astype(np.float32),
             rng.rand(B, T, TIN).astype(np.float32)]
    params = {"encoder.convs.0.weight": torch.randn(4, 3, 5),
              "decoder.gate_proj.bias": torch.randn(1)}
    mine = MetricsLogger(str(tmp_path / "port"))
    mine.log_validation(0.5, params, tuple(map(torch.from_numpy,
                                               (mel_t, gate_t))),
                        tuple(map(torch.from_numpy, preds)), 7)
    theirs = jlogger.MetricsLogger(str(tmp_path / "jax"))
    theirs.log_validation(0.5, {"w": jnp.ones((2, 2))}, (mel_t, gate_t),
                          tuple(jnp.asarray(p) for p in preds), 7)

    def images(calls):
        return [c for c in calls if c[0] == "image"]

    got, want = images(mine.writer.calls), images(theirs.writer.calls)
    assert [c[1] for c in got] == ["alignment", "mel_target",
                                   "mel_predicted", "gate"]
    assert [c[1:2] + c[3:] for c in got] == [c[1:2] + c[3:] for c in want]
    for g, w in zip(got, want):
        assert g[4] == "HWC" and g[2].ndim == 3 and g[2].shape[2] == 3
        assert np.array_equal(g[2], w[2]), g[1]
    hists = [c for c in mine.writer.calls if c[0] == "histogram"]
    assert [c[1] for c in hists] == list(params)
    for c in hists:
        assert np.array_equal(c[2], params[c[1]].numpy().ravel())
        assert c[3] == 7
    assert ("scalar", "validation.loss", 0.5, 7) in mine.writer.calls
    writer = mine.writer
    mine.close()
    mine.close()
    assert writer.closed == 1 and mine.writer is None
    mine.log_training(1.0, 1.0, 1e-3, 0.1, 8)       # closed: dropped


def test_json_lines_logger_close_does_nothing(tmp_path, monkeypatch):
    """Without tensorboardX: the scalars as JSON lines, no images, and a
    ``close`` that leaves the file usable."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    log = MetricsLogger(str(tmp_path))
    assert log.writer is None
    log.log_validation(0.25, {"w": torch.ones(2)}, (None, None),
                       (None, None, None, None), 3)
    log.close()
    log.close()
    log.log_training(1.0, 2.0, 1e-3, 0.1, 4)
    with open(tmp_path / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows == [{"iteration": 3, "validation.loss": 0.25},
                    {"iteration": 4, "training.loss": 1.0, "grad.norm": 2.0,
                     "learning.rate": 1e-3, "duration": 0.1}]


_NO_PLOTS = """
import json, os, sys
for m in ('matplotlib', 'tensorboardX', 'jax', 'flax'):
    sys.modules[m] = None
from text2speech_tpu_torch.config import HParams
from text2speech_tpu_torch.train.tacotron import TacotronTrainer
hp_path, corpus, run = sys.argv[1:4]
trainer = TacotronTrainer(HParams.load(hp_path), [corpus], run,
                          num_test_per_speaker=2, device="cpu")
trainer.fit(2)
loss = trainer.validate(2)
trainer.logger.close()
trainer.ckpt.close()
print(json.dumps({"loss": loss, "tb": sorted(os.listdir(run + "/tb")),
                  "plotted": "matplotlib.pyplot" in sys.modules}))
"""


def test_validation_without_matplotlib_or_tensorboardx(tmp_path):
    """As on the card's machine: the trainer validates (at its checkpoint
    step and again by hand) and closes; only ``scalars.jsonl`` is
    written, and nothing imported matplotlib."""
    from tests.test_torch_tacotron_data import HP, write_corpus

    corpus = write_corpus(str(tmp_path / "corpus"))
    HP.replace(checkpoint_interval=2).save(str(tmp_path / "hp.json"))
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", _NO_PLOTS,
                        str(tmp_path / "hp.json"), corpus,
                        str(tmp_path / "run")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["loss"]) and out["tb"] == ["scalars.jsonl"]
    assert not out["plotted"]
    with open(tmp_path / "run" / "tb" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert sum("validation.loss" in r for r in rows) == 2


def test_checkpoint_manager_close(tmp_path):
    """Saves are synchronous, so ``close`` has nothing to wait for: the
    checkpoint is whole before it, and it can be called again.  Under a
    group (gloo, one rank) it ends with the barrier ``save`` uses."""
    from text2speech_tpu_torch.train.checkpoint import CheckpointManager
    from text2speech_tpu_torch.train.state import create_train_state

    lin = torch.nn.Linear(3, 2)
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(4, create_train_state(lin, 1e-3))
    mgr.close()
    mgr.close()
    assert mgr.all_steps() == [4]
    assert set(mgr.load_params()) == {"weight", "bias"}
    code = textwrap.dedent(f"""
        import socket, torch, torch.distributed as dist
        from text2speech_tpu_torch.train.checkpoint import CheckpointManager
        from text2speech_tpu_torch.train.state import create_train_state
        s = socket.socket(); s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]; s.close()
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                                world_size=1, rank=0)
        mgr = CheckpointManager({str(tmp_path / "b")!r},
                                group=dist.group.WORLD)
        mgr.save(1, create_train_state(torch.nn.Linear(3, 2), 1e-3))
        mgr.close(); mgr.close()
        print(mgr.all_steps())
        dist.destroy_process_group()
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "[1]"
