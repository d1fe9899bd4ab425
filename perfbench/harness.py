"""The harness: finds a cell's files by its name, runs its traffic kind,
reads its metrics and prints the result.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is a file of its own, found by name:

* ``perfbench/workloads/<cell>.json``: the configuration's name, the
  traffic kind, the cards, the traffic's parameters;
* ``perfbench/configs/<config>.json``: the model's widths, its source,
  what was reduced and what was assumed;
* ``perfbench/traffic/<kind>.py``: the generator and the entry it drives,
  ``run(ctx) -> Outcome``;
* ``perfbench/metrics/<metric>.py``: ``read(obs) -> float | None``.

Which metrics a cell reports is read from BENCHMARK.json at the root:
its end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``)."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "text2speech_tpu")


@dataclass
class Context:
    """What a traffic kind is given.  ``device``: ``"cuda"`` on the card;
    a test passes ``"cpu"`` with a small configuration."""

    cell_name: str
    cell: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    control: bool = False
    fault: str | None = None


@dataclass
class Outcome:
    """What a traffic kind returns: ``checks`` maps a short name to
    (number, limit); the run is correct when every number is at most its
    limit."""

    attempted: int
    failed: int
    e2e: dict
    checks: dict
    memory_peak_bytes: int
    obs: object = None
    notes: dict = field(default_factory=dict)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, base: str = HERE) -> tuple:
    """(cell, configuration) of a workload name, from the files under
    ``base``."""
    cell = load_json(base, "workloads", f"{name}.json")
    return cell, load_json(base, "configs", f"{cell['config']}.json")


def cell_metrics(name: str, bench: dict) -> tuple:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that the
    cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return e2e, layer


def read_metric(name: str, obs):
    """The per-layer reader ``metrics/<name>.py``'s value, or None."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level packages among ``names`` (default: the
    modules loaded), compared by whole top-level name."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


THREADS = 2


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc builds go to build/t2s_torch by itself), and few host
    threads: the load comes from one process, and idle worker threads on
    a shared host only add jitter to the launch-bound decode."""
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    base = os.path.join(ROOT, "build", "perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def run_cell(ctx: Context):
    """The traffic kind's outcome for one cell."""
    kind = importlib.import_module(f"perfbench.traffic.{ctx.cell['traffic']}")
    return kind.run(ctx)


def result_line(ctx: Context, out: Outcome, layer_names: list,
                e2e_names: list, device: dict) -> dict:
    correct = all(v <= lim for v, lim in out.checks.values())
    res = {"correct": bool(correct and out.failed == 0),
           "attempted": out.attempted, "failed": out.failed}
    metrics = {}
    if ctx.trace:
        from .trace import finish

        finish(out.obs)
        for m in layer_names:
            value = read_metric(m["name"], out.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e_names:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    res["metrics"] = metrics
    res["device"] = device
    if ctx.trace:
        from .trace import breakdown, busy_s, window_s

        device["busy_s"] = busy_s(out.obs)
        device["window_s"] = window_s(out.obs)
        res["breakdown"] = breakdown(out.obs)
    res["notes"] = out.notes
    # a gap that is not finite (a non-finite output, a length that
    # differs) is written as the largest float JSON takes
    res["checks"] = {k: {"value": float(v) if math.isfinite(v) else 1e308,
                         "limit": lim}
                     for k, (v, lim) in out.checks.items()}
    return res


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="run the program's lower-precision paths (the "
                        "control of the correctness check; not a "
                        "benchmark run)")
    args = p.parse_args(argv)
    set_cache_dirs()
    cell, cfg = load_cell(args.workload)
    bench = load_json(ROOT, "BENCHMARK.json")
    e2e, layer = cell_metrics(args.workload, bench)

    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = Context(args.workload, cell, cfg, args.seed, args.seconds,
                  bool(args.trace), t_start, control=bool(args.control))
    out = run_cell(ctx)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    res = result_line(ctx, out, layer, e2e, device)
    print(f"run: {json.dumps(res['notes'])}", file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res, allow_nan=False, default=float))
    return 0
