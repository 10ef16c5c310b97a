#!/usr/bin/env python3
"""The control of `correct`: the plain reference computed one precision
below the configuration's (its IDCT and fDCT products in TF32 where the
configuration states float32 with TF32 off), put in the program's place.

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 [--batches N]

For each seed: the cell's pool, the judge's sample drawn as a run draws it
over the window's first N batches, each sampled output made by the cell's
check (`control_output`), and the check's numbers against the float64
reference. Prints one JSON line a seed with the numbers, the limits and
whether the control failed one of them, which it must.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def sample_indices(traffic: dict, n_streams: int, seed: int, n_batches: int):
    """The stream indices a run over `n_batches` batches would judge."""
    from benchmark import corpus

    draws = corpus.Draws(n_streams, int(traffic["batch"]), seed)
    sample = corpus.Sample(seed, int(traffic["sample_every"]),
                           int(traffic["judge_max"]))
    kept = []
    for k in range(n_batches):
        idx = draws.next()
        j = sample.pick(k, len(idx))
        if j is not None:
            kept.append(idx[j])
    return sample.capped(kept)


def control_numbers(cell: str, seed: int, n_batches: int,
                    overrides: dict = None, workers: int = 0,
                    bench: dict = None) -> dict:
    from benchmark import corpus
    from benchmark.run import cell_of, load_json, merge

    if bench is None:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _w, traffic, _config = cell_of(bench, cell)
    if overrides:
        traffic = merge(traffic, overrides)
    check = importlib.import_module(f"benchmark.checks.{traffic['check']}")
    _specs, streams = corpus.make_streams(traffic["corpus"], seed, workers)
    ks = sample_indices(traffic, len(streams), seed, n_batches)
    samples = [(k, check.control_output(streams, k, traffic)) for k in ks]
    numbers = check.judge(samples, streams, traffic)
    limits = traffic["limits"]
    return {"cell": cell, "seed": seed, "judged": len(samples),
            "numbers": numbers, "limits": limits,
            "failed_one": any(numbers[n] > limits[n] for n in check.NUMBERS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=200)
    args = ap.parse_args(argv)
    ok = True
    for s in args.seeds.split(","):
        r = control_numbers(args.workload, int(s), args.batches)
        ok &= r["failed_one"]
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
