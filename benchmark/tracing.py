"""The traced run's instruments: the program's spans and counters, and a
`torch.profiler` trace of the device.

- Spans and counters: the program's own `core.trace.start_collect` /
  `stop_collect` (span wall times summed over the threads that ran them,
  `add_count` counters).
- Host spans: the program opens each span with
  `torch.cuda.nvtx.range_push` and closes it with `range_pop`; while
  tracing, those calls also stamp the span's start and end on the host
  clock, on whatever thread runs them. The window's own profiler range,
  stamped on the same clock, puts them on the trace's clock, so each gap of
  the device is labelled by the span the host had open during it.
- Device: kernels, copies and sets from the chrome trace. Busy time is the
  union of their intervals on every stream, clipped to the window.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_NAME = "benchmark.window"


def kernel_name(name: str) -> str:
    """A kernel's name without `void`, anonymous namespaces, its argument
    list or template arguments (the whole name where nothing is left)."""
    short = re.sub(r"\(anonymous namespace\)::", "", name)
    short = re.sub(r"^void ", "", short.strip())
    short = short.split("(")[0].split("<")[0].strip()
    return short or name


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out = []
    t = lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class _NvtxRanges:
    """While installed, every `torch.cuda.nvtx.range_push` /
    `range_pop` pair also records (start, end, name) on the host clock
    (time.perf_counter), on whatever thread calls it."""

    def __init__(self):
        import torch

        self.nvtx = torch.cuda.nvtx
        self.local = threading.local()
        self.spans = []  # (start, end, name); list.append is atomic
        self.saved = None

    def install(self):
        push, pop = self.nvtx.range_push, self.nvtx.range_pop
        self.saved = (push, pop)

        def range_push(msg):
            stack = getattr(self.local, "stack", None)
            if stack is None:
                stack = self.local.stack = []
            stack.append((msg, time.perf_counter()))
            return push(msg)

        def range_pop():
            stack = getattr(self.local, "stack", None)
            if stack:
                msg, t0 = stack.pop()
                self.spans.append((t0, time.perf_counter(), msg))
            return pop()

        self.nvtx.range_push, self.nvtx.range_pop = range_push, range_pop

    def remove(self):
        if self.saved is not None:
            self.nvtx.range_push, self.nvtx.range_pop = self.saved
            self.saved = None


class Tracer:
    """Collects spans and counters, and on a CUDA device a profiler trace,
    around the measured window: `with Tracer(...) as t: ... with
    t.window(): <the window>`; then `t.spans`, `t.counters`, `t.device`."""

    def __init__(self, device, trace_dir: str):
        self.device = device
        self.trace_dir = trace_dir
        self.spans: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.device_summary = None
        self._prof = None
        self._nvtx = None
        self._window_pc = None

    def __enter__(self):
        import torch
        from nvimagecodec_tpu_torch.core import trace

        trace.start_collect()
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self._nvtx = _NvtxRanges()
            self._nvtx.install()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            torch.cuda.synchronize()
            self._prof.__enter__()
        return self

    def window(self):
        """The profiler range of the window, stamped on the host clock."""
        import torch

        self._window_pc = time.perf_counter()
        return torch.autograd.profiler.record_function(WINDOW_NAME)

    def __exit__(self, *exc):
        import torch
        from nvimagecodec_tpu_torch.core import trace

        try:
            if self._prof is not None:
                torch.cuda.synchronize()
                self._prof.__exit__(*exc)
        finally:
            if self._nvtx is not None:
                self._nvtx.remove()
            got = trace.stop_collect()
        self.spans = dict(got["spans"])
        self.counters = dict(got["counters"])
        if self._prof is not None and exc[0] is None:
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, "benchmark_trace.json")
            self._prof.export_chrome_trace(path)
            try:
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            finally:
                os.remove(path)
            host = self._nvtx.spans if self._nvtx is not None else []
            self.device_summary = summarise(events, host, self._window_pc)
        return False


def summarise(events: list, host_spans=(), window_pc=None) -> dict:
    """From chrome-trace events: the window's length, the device's busy
    time (union over streams), seconds per kernel name, seconds per device
    operation, and idle time by the host span open during it. host_spans
    are (start, end, name) on the host clock, on which the window's range
    began at window_pc; profiler ranges of the trace count as spans too."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_NAME]
    if not win:
        raise RuntimeError("the trace has no window range")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    busy = []
    kernels: Dict[str, float] = defaultdict(float)
    ops: Dict[str, float] = defaultdict(float)
    spans = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            busy.append((s, t))
            name = (kernel_name(e["name"]) if cat == "kernel"
                    else e["name"])
            ops[name] += (t - s) * 1e-6
            if cat == "kernel":
                kernels[name] += (t - s) * 1e-6
        elif cat == "user_annotation" and e.get("name") != WINDOW_NAME:
            spans.append((s, t, e["name"]))
    if window_pc is not None:
        shift = lo - window_pc * 1e6
        spans += [(a * 1e6 + shift, b * 1e6 + shift, name)
                  for a, b, name in host_spans]
    idle: Dict[str, float] = defaultdict(float)
    spans.sort()
    active, k = [], 0
    for a, b in gaps(busy, lo, hi):  # gaps come in order of time
        while k < len(spans) and spans[k][0] < b:
            active.append(spans[k])
            k += 1
        active = [sp for sp in active if sp[1] > a]
        # the innermost span (the shortest) of those covering at least
        # half of the gap, else the one covering most of it
        label, best = "no program span", None
        for s, t, name in active:
            cover = min(t, b) - max(s, a)
            if cover <= 0:
                continue
            rank = ((t - s) if cover * 2 >= b - a else float("inf"), -cover)
            if best is None or rank < best:
                best, label = rank, name
        idle[label] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": union_length(busy) * 1e-6,
            "kernels_s": dict(kernels),
            "device_ops": top(ops),
            "idle_gaps": top(idle)}
