#!/usr/bin/env python3
"""Runs of one cell in a row, each in a process of its own, and their
spread: what a bound is set from.

    python3 benchmark/sets.py --workload CELL --seeds 1,2,3 --seconds S
        [--trace 0|1] [--out FILE] [--sets 2]

Each run is `benchmark/run.py` with one seed; its result line is appended
to FILE (JSON lines, with the seed and the set). With `--sets 2` the seeds
run twice, the second set after the first. At the end, for each metric and
set: the median, the quartiles (statistics.quantiles(n=4)) and the spread,
(q3 - q1) / median, and every run's `correct`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    """(median, q1, q3, (q3 - q1) / median) of values."""
    if len(values) < 2:
        v = values[0]
        return v, v, v, 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / med if med else float("inf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--limit", type=float, default=1200.0,
                    help="seconds a run may take")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = []
    for k in range(args.sets):
        for seed in seeds:
            cmd = [sys.executable, os.path.join(HERE, "run.py"),
                   "--workload", args.workload, "--seed", str(seed),
                   "--seconds", args.seconds, "--trace", args.trace]
            t = time.perf_counter()
            try:
                r = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                   text=True, timeout=args.limit)
                rc, out, err = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, out, err = 124, e.stdout or "", e.stderr or ""
            took = time.perf_counter() - t
            last = (out.strip().splitlines() or [""])[-1]
            try:
                res = json.loads(last)
            except json.JSONDecodeError:
                res = None
            rec = {"set": k, "seed": seed, "rc": rc, "wall_s": took,
                   "result": res}
            if res is None:
                rec["stderr_tail"] = (err if isinstance(err, str)
                                      else err.decode())[-3000:]
            lines.append(rec)
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    names = sorted({n for r in lines if r["result"]
                    for n in r["result"]["metrics"]})
    for k in range(args.sets):
        runs = [r["result"] for r in lines if r["set"] == k and r["result"]]
        print(f"set {k}: correct {[r['correct'] for r in runs]}")
        for n in names:
            vals = [r["metrics"][n]["value"] for r in runs
                    if n in r["metrics"]]
            if vals:
                med, q1, q3, sp = spread(vals)
                print(f"  {n}: median {med!r} q1 {q1!r} q3 {q3!r} "
                      f"spread {sp:.4f} n {len(vals)}")
    return 0 if all(r["rc"] == 0 for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
