"""The harness on the CPU: its files are found by name, its names keep to
the contract's characters, its traffic is a function of the seed alone,
it refuses to run without a card, and it imports neither JAX nor the JAX
package, nor (in the reference) the port.  A run of a cell can be driven
here at a small configuration through ``harness.run_cell``."""

import ast
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import harness, inputs
from perfbench.traffic import serve_open, train_dp

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def small(cfg: dict) -> dict:
    """A configuration small enough for the CPU (every width cut)."""
    cfg = copy.deepcopy(cfg)
    cfg["tacotron"].update(
        embedding_size=32, enc_conv_channels=32, decoder_rnn_dim=64,
        attention_rnn_dim=64, prenet_dim=32, attention_dim=16,
        attention_location_n_filters=8, postnet_embedding_dim=32)
    cfg["waveglow"].update(wn_n_channels=16, wn_n_layers=3, n_flows=5,
                           n_early_every=2, segment_length=4096)
    return cfg


SMALL_PARAMS = {
    "offline": {"batch": 4, "max_steps": 32, "check_rows": 2,
                "check_block": 2},
    "serve_open": {"slots": 2, "max_steps": 48, "chunk_steps": 16,
                   "rate_per_s": 2.0, "check_sessions": 2, "check_block": 2,
                   "drain_s": 30},
    "train_dp": {"rows_per_rank": 2},
}


def small_run(name: str, seconds: float = 1.5, base=harness.HERE,
              **kw):
    """One run of a cell at a small configuration on the CPU (the train
    cell over two gloo ranks)."""
    cell, cfg = harness.load_cell(name, base)
    cell = copy.deepcopy(cell)
    cell["params"].update(SMALL_PARAMS[cell["traffic"]])
    if cell["traffic"] == "train_dp":
        cell["chips"] = 2
    ctx = harness.Context(name, cell, small(cfg), 2 ** 31 + 77, seconds,
                          False, time.perf_counter(), device="cpu", **kw)
    return harness.run_cell(ctx)


def test_every_cell_has_its_files():
    names = {w["name"] for w in BENCH["workloads"]}
    assert names <= set(CELLS)
    for name in CELLS:
        cell, cfg = harness.load_cell(name)
        assert (HERE / "traffic" / f"{cell['traffic']}.py").is_file()
        assert cell["chips"] in (1, 4)
        assert cfg["name"] == cell["config"]
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        src = (HERE / "metrics" / f"{m['name']}.py").read_text()
        assert "def read(obs)" in src
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        e2e, layer = harness.cell_metrics(w["name"], BENCH)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


def test_names_and_units_keep_to_the_contract():
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[: len(BENCH["end_to_end"])
                       + len(BENCH["per_layer"])])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" not in f.parts:
                rel = f.relative_to(ROOT).as_posix()
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_every_entry_has_exactly_the_contract_keys():
    """BENCHMARK.json is refused before any run for a key too many or too
    few, so each entry's keys are pinned here."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    texts = ([c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_traffic_is_a_function_of_the_seed_alone():
    spec = {"median": 28, "sigma": 0.55, "min": 8, "max": 90}
    big = 2 ** 31 + 12345
    assert inputs.texts(big, 3, 16, spec) == inputs.texts(big, 3, 16, spec)
    assert inputs.texts(big, 3, 16, spec) != inputs.texts(big + 1, 3, 16,
                                                          spec)
    p = harness.load_cell("wg512-serve-poisson")[0]["params"]
    a = serve_open.schedule(big, p, 20.0)
    assert a == serve_open.schedule(big, p, 20.0)
    b = serve_open.schedule(big + 1, p, 20.0)
    assert a != b
    # the same work in another order: sizes, gaps and the denoised share
    def work(s):
        gaps = sorted(round(y[0] - x[0], 9) for x, y in zip(s, s[1:]))
        return (sorted(len(t) for _, t, _, _ in s), len(s),
                sum(d > 0 for *_, d in s), round(s[-1][0], 6))
    assert work(a)[1:3] == work(b)[1:3]
    # arrivals bunch alike for every seed: the due times are one sequence
    assert [s[0] for s in a] == [s[0] for s in b]
    assert [s[1] for s in a] != [s[1] for s in b]
    assert sorted(inputs.quantile_sizes(40, spec)) == \
        inputs.quantile_sizes(40, spec)
    x = train_dp.audio_batch(big, 2, 3, 800, 22050, "cpu")
    assert (x == train_dp.audio_batch(big, 2, 3, 800, 22050, "cpu")).all()
    assert not (x == train_dp.audio_batch(big, 3, 3, 800, 22050,
                                          "cpu")).all()


def test_texts_encode_alike_in_the_reference_and_the_port():
    from text2speech_tpu_torch.text import text_to_sequence

    from perfbench.reference.text import symbol_ids

    spec = {"median": 28, "sigma": 0.55, "min": 8, "max": 90}
    for t in inputs.texts(5, 0, 64, spec):
        ids = symbol_ids(t)
        assert len(ids) <= inputs.MAX_SYMBOLS
        assert list(text_to_sequence(t)) == ids


def test_a_run_without_a_card_fails_and_prints_no_result():
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "wg512-offline-b32", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_nothing_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "text2speech_tpu", "benchmarks",
              "bench", "chip_smoke", "profile_torch"}
    for f in HERE.rglob("*.py"):
        top = {m.split(".")[0] for m in _imports(f)}
        assert not top & banned, (f, top & banned)


def test_the_reference_imports_nothing_of_the_port():
    for f in (HERE / "reference").rglob("*.py"):
        top = {m.split(".")[0] for m in _imports(f)}
        assert top <= {"torch", "numpy", "math", "__future__"}, (f, top)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["text2speech_tpu_torch.infer",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["text2speech_tpu.models", "jax.numpy",
                                      "flax"]) == ["flax", "jax",
                                                   "text2speech_tpu"]


def test_a_new_workload_file_adds_a_cell(tmp_path):
    """A cell is its file: a copy of the cell files with one more workload
    runs that cell, and BENCHMARK.json's entry gives it its metrics."""
    for d in ("workloads", "configs"):
        shutil.copytree(HERE / d, tmp_path / d)
    cell = json.loads((HERE / "workloads" / "wg512-offline-b32.json")
                      .read_text())
    cell["params"]["batch"] = 3
    (tmp_path / "workloads" / "wg512-offline-b3.json").write_text(
        json.dumps(cell))
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "wg512-offline-b3",
                               "config": "t2-wg512", "traffic": "offline",
                               "chips": 1, "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "wg512-offline-b32" in m.get("workloads", []):
            m["workloads"].append("wg512-offline-b3")
    e2e, layer = harness.cell_metrics("wg512-offline-b3", bench)
    assert {m["name"] for m in e2e} == {"audio_s_per_s", "setup_s"}
    assert {m["name"] for m in layer} >= {"mfu.offline"}
    out = small_run("wg512-offline-b3", base=str(tmp_path))
    assert out.attempted % 4 == 0 and out.e2e["audio_s_per_s"] > 0
