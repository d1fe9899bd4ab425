"""The program's spans in the benchmark, on the CPU: ``spans.recorder``
installs the port's recorder only in a traced run (and nothing for a port
without one), ``spans.merge`` puts its spans and counters into an
``Observation`` so that ``breakdown`` names gaps by them, and each reader
of a program span or counter returns None without it and the value
computed by hand on a synthetic run."""

from types import SimpleNamespace

import pytest

from perfbench import harness, spans
from perfbench.test_perfbench_harness import small_run
from perfbench.trace import Observation, breakdown
from text2speech_tpu_torch.utils import profiling

READERS = ("decode_ms_per_step.offline", "decode_idle.offline",
           "text_ms.offline", "load_s.offline", "allreduce_busbw.train")


def synthetic() -> Observation:
    """A traced slice from 1 s to 2 s (host clock); device operations in
    microseconds on the same clock."""
    obs = Observation(slice_s=(1.0, 2.0))
    obs.spans = [
        ("convert.waveglow", 0.1, 0.5), ("convert.waveglow", 0.2, 0.4),
        ("synth.derive", 0.5, 0.6), ("ops.build", 0.7, 0.9),
        ("ops.load", 0.9, 0.95), ("synth.text", 0.96, 0.97),
        ("taco.decoder", 0.5, 0.6),
        ("batch", 1.0, 1.9), ("synth.text", 1.0, 1.004),
        ("taco.decoder", 1.1, 1.3), ("synth.text", 1.4, 1.402),
        ("taco.decoder", 1.5, 1.6), ("ops.build", 1.65, 1.7)]
    obs.counters = {
        "taco.decoder_steps": [(0.55, 999), (1.2, 100), (1.55, 50)],
        "train.allreduce_bytes": [(0.5, 1e9), (1.1, 1e9), (1.6, 1e9)]}
    obs.ops = [("k", 1.1e6, 0.05e6), ("k", 1.28e6, 0.05e6),
               ("k", 1.4e6, 0.05e6), ("k", 1.55e6, 0.01e6),
               ("ncclDevKernel_AllReduce", 1.7e6, 4000.0),
               ("ncclDevKernel_AllReduce", 1.8e6, 4000.0)]
    obs.info["ranks"] = 4
    return obs


WANT = {
    # 300 ms of decoder spans in the slice over 150 counted steps
    "decode_ms_per_step.offline": 2.0,
    # busy 50 + 20 (clipped at the span's end) + 10 of 300 ms
    "decode_idle.offline": 100.0 * (1.0 - 80.0 / 300.0),
    "text_ms.offline": 3.0,
    # 0.1-0.6, 0.7-0.95 s: the nested convert.* counted once
    "load_s.offline": 0.75,
    # 2 GB in the slice x 2 (4 - 1) / 4 over 8 ms of NCCL kernels
    "allreduce_busbw.train": 2e9 * 1.5 / 8e-3 / 1e9,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_run(name):
    assert harness.read_metric(name, synthetic()) == pytest.approx(
        WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_spans_reads_nothing(name):
    assert harness.read_metric(name, Observation()) is None
    bare = synthetic()
    bare.spans = [s for s in bare.spans if s[0] == "batch"]
    bare.counters = {}
    assert harness.read_metric(name, bare) is None


def test_busbw_needs_the_rank_count():
    obs = synthetic()
    del obs.info["ranks"]
    assert harness.read_metric("allreduce_busbw.train", obs) is None


def test_merge_names_gaps_by_the_program_spans():
    obs = Observation(ops=[("k1", 0.0, 10.0), ("k2", 40.0, 10.0),
                           ("k1", 60.0, 5.0)], slice_s=(0.0, 100e-6))
    obs.spans = [("batch", 0.0, 100e-6), ("text_to_mel", 5e-6, 45e-6)]
    rec = SimpleNamespace(
        spans=[("taco.decoder", 10e-6, 40e-6, None, 0)],
        counters={"taco.decoder_steps": [(20e-6, 3)]})
    spans.merge(obs, rec, ranks=2)
    assert ("taco.decoder", 10e-6, 40e-6) in obs.spans
    assert obs.counters["taco.decoder_steps"] == [(20e-6, 3)]
    assert obs.info["ranks"] == 2
    gaps = breakdown(obs)["idle_gaps"]
    assert gaps[0] == ["batch", pytest.approx(35e-6)]
    assert gaps[1] == ["taco.decoder", pytest.approx(30e-6)]
    spans.merge(obs, None)
    assert len(obs.spans) == 3


def test_recorder_only_in_a_traced_run(monkeypatch):
    with spans.recorder(False) as rec:
        assert rec is None and profiling._RECORDER is None
    with spans.recorder(True) as rec:
        assert rec is profiling._RECORDER is not None
        with profiling.annotate("wg.flows"):
            pass
    assert profiling._RECORDER is None
    assert [s[0] for s in rec.spans] == ["wg.flows"]
    # a port without recording(): nothing to install, nothing to merge
    monkeypatch.delattr(profiling, "recording")
    with spans.recorder(True) as rec:
        assert rec is None


@pytest.mark.parametrize("cell", ["wg512-offline-b32", "wg512-train-dp4"])
def test_an_untraced_run_installs_no_recorder(cell, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a recorder was installed with --trace 0")

    monkeypatch.setattr(profiling.Recorder, "__init__", refuse)
    out = small_run(cell)
    assert all(v <= lim for v, lim in out.checks.values())
    assert profiling._RECORDER is None
