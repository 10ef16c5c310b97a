#!/usr/bin/env python3
"""The benchmark of nvimagecodec_tpu_torch: one cell, one run, one process.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Everything is found by name from BENCHMARK.json at the repository's root:
the cell's traffic mix is `benchmark/traffic/<cell>.json`, its
configuration `benchmark/configs/<config>.json`, the path it drives
`benchmark/entries/<entry>.py`, the comparison that decides `correct`
`benchmark/checks/<check>.py`, and each metric `benchmark/metrics/<name>.py`.

A run:
1. makes the cell's pool of JPEG streams from the seed with the benchmark's
   own encoder (corpus.py), in worker processes that start first and work
   while this process loads torch and builds the program's objects;
2. warms up: every stream of the pool once, then the traffic's
   `warmup_batches` drawn batches (set-up ends here: `setup_s`);
3. measures for `--seconds`: a closed loop in which the program pulls the
   next batch of seeded draws from the pool whenever it has room, stamped
   when pulled and when its images (or bytes) are in hand; the loop stops
   pulling at the close, and what is in flight drains uncounted;
4. judges a seeded sample of the window's outputs against the plain
   reference (the traffic's `check`), once the program's state is freed;
5. prints each number compared beside its limit as the last lines on
   standard error, and one JSON line last on standard output.

With `--trace 1` the window also runs under the program's span collection
and `torch.profiler`, and the line carries the per-layer metrics, the
device's busy and window seconds and a breakdown. Without a CUDA device, or
with fewer than the cell asks for, the run exits 2 and prints no result; a
run that finds JAX or the JAX package loaded once its metrics are read, just
before the result is built, exits 3 and prints none.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
METRICS = os.path.join(HERE, "metrics")
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that no run may load, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "nvimagecodec_tpu")
# files of the repository that may change without the benchmark
FORBIDDEN_FILES = ("tests", "tools", "chip_smoke.py", "bench_torch.py",
                   "bench.py", "bench_scaling.py")


class NoDevice(RuntimeError):
    """No CUDA device, or fewer than the cell asks for."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module from a file of this folder, by path (metric files carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, name: str):
    """(workload entry, traffic, configuration) of a cell by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{w['traffic']}.json"))
    config = load_json(os.path.join(HERE, "configs", f"{w['config']}.json"))
    if traffic.get("config") != w["config"]:
        raise ValueError(f"traffic {w['traffic']} is for "
                         f"{traffic.get('config')}, the cell for "
                         f"{w['config']}")
    return w, traffic, config


def metrics_for(bench: dict, cell: str, per_layer: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def merge(base: dict, over: dict) -> dict:
    """base with over's keys put in, nested dictionaries merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Feed:
    """The batches the program pulls: lists of streams, each stamped when
    pulled. Stops at `stop_at` (perf_counter seconds) or when `order` is
    spent."""

    def __init__(self, order, streams, stop_at: float = float("inf")):
        self.order = iter(order)
        self.streams = streams
        self.stop_at = stop_at
        self.pulled = []  # (perf_counter, [stream indices])

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        if now >= self.stop_at:
            raise StopIteration
        idx = next(self.order)
        self.pulled.append((now, idx))
        return [self.streams[i] for i in idx]


class Close(threading.Thread):
    """Reads the process's CPU time at the window's close."""

    def __init__(self, at: float):
        super().__init__(daemon=True)
        self.at = at
        self.cpu = None

    def run(self):
        time.sleep(max(0.0, self.at - time.perf_counter()))
        self.cpu = time.process_time()


def drive(entry, feed: Feed, keep=None):
    """Run the entry over the feed to its end. Returns [(pulled, done,
    images, good)] a batch; keep(k, idx, outs) sees every batch."""
    done = []
    for k, outs in enumerate(entry.run(feed)):
        t = time.perf_counter()
        pulled, idx = feed.pulled[k]
        if len(outs) != len(idx):
            raise RuntimeError(f"batch {k}: {len(outs)} outputs for "
                               f"{len(idx)} inputs")
        done.append((pulled, t, len(idx), sum(o is not None for o in outs)))
        if keep is not None:
            keep(k, idx, outs)
    return done


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_power_limit():
    """The card's power limit in W as nvidia-smi reads it, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def loaded_forbidden():
    """Loaded modules that a run may not load: JAX or the JAX package (by
    whole top-level name), or files of the repository outside the program
    and this folder."""
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN_MODULES))
    bad_roots = tuple(os.path.join(ROOT, f) for f in FORBIDDEN_FILES)
    for name, mod in list(sys.modules.items()):
        path = getattr(mod, "__file__", None) or ""
        if path and os.path.abspath(path).startswith(bad_roots):
            found.append(name)
    return found


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None,
             gen_workers: int = 0, bench: dict = None) -> dict:
    """One run of a cell; returns the result line's object. `overrides`
    are merged into the traffic (the tests' tiny sizes); `gen_workers`
    processes make the corpus (0: one a core less two, at most 6);
    `bench` stands for BENCHMARK.json (the tests run traffic files it does
    not name)."""
    if bench is None:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w, traffic, config = cell_of(bench, cell)
    if overrides:
        traffic = merge(traffic, overrides)

    from benchmark import corpus

    with corpus.Pending(traffic["corpus"], seed, gen_workers) as pending:
        return _run(pending, bench, w, traffic, config, seed, seconds,
                    trace, device)


def _run(pending, bench, w, traffic, config, seed, seconds, trace,
         device):
    """run_cell's body, while `pending` makes the corpus."""
    cell = w["name"]
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    chips = int(w["chips"])
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoDevice(f"cell {cell} needs {chips} CUDA device(s); "
                       f"{found} found")
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(dev)

    from benchmark import corpus
    from benchmark.tracing import Tracer

    entry_mod = importlib.import_module(
        f"benchmark.entries.{traffic['entry']}")
    check = importlib.import_module(f"benchmark.checks.{traffic['check']}")
    entry = entry_mod.Entry(traffic, dev)
    batch = int(traffic["batch"])
    # the corpus, made meanwhile: corpus_s what the workers took,
    # corpus_wait_s what set-up waited for it here
    t_wait = time.perf_counter()
    specs, streams = pending.result()
    t_wait = time.perf_counter() - t_wait

    # warm-up: every stream of the pool once, then drawn batches
    warm = [list(range(i, min(i + batch, len(streams))))
            for i in range(0, len(streams), batch)]
    wdraws = corpus.Draws(len(streams), batch, seed, path=6)
    warm += [wdraws.next() for _ in range(int(traffic["warmup_batches"]))]
    t_warm = time.perf_counter()
    warm_done = drive(entry, Feed(warm, streams))
    sync(dev)
    t_warm = time.perf_counter() - t_warm
    if sum(g for *_x, g in warm_done) == 0:
        raise RuntimeError("the warm-up decoded nothing")
    warm_peak = 0
    if dev.type == "cuda":
        warm_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - _T0

    # the window
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jbatch
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as jenc

    sample = corpus.Sample(seed, int(traffic["sample_every"]),
                           int(traffic["judge_max"]))
    kept = []

    def keep(k, idx, outs):
        j = sample.pick(k, len(idx))
        if j is not None:
            out = outs[j]
            kept.append((idx[j], None if out is None else entry.keep(out)))

    routes0, enc0 = dict(jbatch.ROUTES), dict(jenc.ROUTES)
    tracer = Tracer(dev, os.environ.get("TMPDIR") or HERE) if trace else None
    if tracer is not None:
        tracer.__enter__()
    try:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        close = Close(deadline)
        cpu0 = time.process_time()
        close.start()
        draws = corpus.Draws(len(streams), batch, seed)
        feed = Feed(iter(draws.next, None), streams, stop_at=deadline)
        if tracer is not None:
            with tracer.window():
                batches = drive(entry, feed, keep)
                sync(dev)
        else:
            batches = drive(entry, feed, keep)
            sync(dev)
        close.join()
    finally:
        if tracer is not None:
            tracer.__exit__(*sys.exc_info())
    routes = {k: jbatch.ROUTES[k] - routes0[k] for k in routes0}
    enc_routes = {k: jenc.ROUTES[k] - enc0[k] for k in enc0}
    win_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

    # free the program's state, then judge
    del entry
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = sample.capped(kept)
    t_judge = time.perf_counter()
    numbers = check.judge(kept, streams, traffic)
    judge_s = time.perf_counter() - t_judge
    limits = traffic["limits"]
    checks = {n: {"value": numbers[n], "limit": limits[n]}
              for n in check.NUMBERS}

    in_window = [b for b in batches if b[1] <= deadline]
    attempted = sum(len(idx) for _t, idx in feed.pulled)
    failed = sum(n - g for _p, _d, n, g in batches)
    run = SimpleNamespace(
        cell=cell, traffic=traffic, config=config, seconds=seconds,
        batches=in_window, images=sum(g for *_x, g in in_window),
        cpu_s=None if close.cpu is None else close.cpu - cpu0,
        mem_peak_bytes=win_peak, device_name=(
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        pulled=feed.pulled, specs=specs, streams=streams, routes=routes,
        encode_routes=enc_routes,
        spans=tracer.spans if tracer else {},
        counters=tracer.counters if tracer else {},
        device_trace=tracer.device_summary if tracer else None)
    metrics = {}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for m in metrics_for(bench, cell, trace):
        if m["name"] == "setup_s":
            continue
        reader = load_file(os.path.join(METRICS, f"{m['name']}.py"),
                           "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    e2e_missing = [m["name"] for m in metrics_for(bench, cell, False)
                   if not trace and dev.type == "cuda"
                   and m["name"] not in metrics]
    # the window, the judge and every metric reader have run: nothing they
    # loaded may be JAX or the JAX package
    bad = loaded_forbidden()
    if bad:
        raise ImportError("loaded during the run: " + ", ".join(bad))
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and failed == 0 and bool(kept) and bool(in_window)
               and not e2e_missing)

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": run.device_name,
                         "count": chips,
                         "memory_peak_bytes": max(warm_peak, win_peak)}}
    if trace and run.device_trace is not None:
        result["device"]["busy_s"] = run.device_trace["busy_s"]
        result["device"]["window_s"] = run.device_trace["window_s"]
        result["breakdown"] = {"device_ops": run.device_trace["device_ops"],
                               "idle_gaps": run.device_trace["idle_gaps"]}
    result["detail"] = {"power_limit_w": card_power_limit()
                      if dev.type == "cuda" else None,
                      "seed": seed, "corpus_s": pending.seconds,
                      "corpus_wait_s": t_wait, "warmup_s": t_warm,
                      "judged": len(kept),
                      "judge_s": judge_s, "routes": routes,
                      "encode_routes": enc_routes}
    if e2e_missing:
        result["detail"]["missing_metrics"] = e2e_missing
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """Each number compared beside its limit, last on standard error; the
    result last on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None, **run_kw) -> int:
    """The command; `run_kw` go to run_cell (the tests' CPU runs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), **run_kw)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
