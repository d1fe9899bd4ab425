"""The knee of a serving cell: one server, built once, driven open-loop at
each of several rates for a short window; per rate the requests, how
many finished within the window and the drain, the queue when the window
closed, and the first-audio and chunk-gap percentiles.  Run on the card:

    python3 perfbench/sweep.py --workload wg512-serve-poisson --seed 7 \\
        --seconds 20 --rates 3,4,5,6
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from perfbench import harness
    from perfbench.trace import Observation
    from perfbench.traffic import common, serve_open

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    harness.set_cache_dirs()
    cell, cfg = harness.load_cell(args.workload)
    ctx = harness.Context(args.workload, cell, cfg, args.seed, args.seconds,
                          False, time.perf_counter())
    _, _, _, srv = serve_open.build(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        p = dict(cell["params"], rate_per_s=rate)
        sched = serve_open.schedule(args.seed, p, args.seconds)
        obs = Observation()
        out = serve_open.drive(srv, sched, args.seconds, 60.0, obs)
        first, gaps, failed = serve_open.latencies(out)
        in_window = sum(1 for rec in out["recs"].values()
                        if rec["events"] and rec["done"]
                        and rec["events"][-1][0] <= args.seconds)
        steps = obs.spans_named("step")
        print(json.dumps({
            "rate_per_s": rate, "requests": len(sched),
            "finished_in_window": in_window, "failed": failed,
            "drain_end_s": out["end"],
            "queued_at_window_end": next(
                (q for t, q in obs.counters["queued"]
                 if t - obs.info["t0"] >= args.seconds), 0),
            "queued_max": max(q for _, q in obs.counters["queued"]),
            "first_audio_p50_ms": 1e3 * common.pct(first, 50),
            "first_audio_p95_ms": 1e3 * common.pct(first, 95),
            "chunk_gap_p95_ms": 1e3 * common.pct(gaps, 95),
            "round_ms_p50": 1e3 * common.pct([b - a for a, b in steps], 50),
            "rounds": out["rounds"]}), flush=True)
