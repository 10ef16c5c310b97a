"""Profiling spans as NVTX ranges, and an in-process collector of them.

The API of nvimagecodec_tpu/core/trace.py, extended: `span(name)` opens a
range that shows in Nsight Systems and in `torch.profiler` traces beside the
kernels (ranges are emitted only when CUDA is available). Between
`start_collect()` and `stop_collect()` every span also leaves a record:

- its name and thread, its start and end (`time.perf_counter_ns`), and the
  CPU time of its thread over it (`time.thread_time_ns`);
- its parent, the innermost open span of the same request, and its batch,
  the id of the request's root span. The current span lives in a
  `contextvars.ContextVar`; `bind(fn)` carries it onto the thread that runs
  `fn`, so a batch keeps its ids across the scheduler's and the codecs'
  thread pools.

`charge(name)` adds a pool task's CPU time to the named span's CPU total and
leaves no record: cheap enough for each image; `charge_ns(name, ns)` adds CPU
time measured elsewhere (a native library's own worker threads, which
`collecting()` tells it to measure). `add_count` accumulates counters. With
collection off a span is one check and its NVTX push and pop; `charge`,
`charge_ns` and `bind` are one check.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time

import torch

_COLLECT = None
_COLLECT_LOCK = threading.Lock()
_NVTX = [None]  # decided at the first span, never at import
_CURRENT = contextvars.ContextVar("imgcodec_span", default=None)
_IDS = itertools.count(1)


def start_collect() -> None:
    """Begin collecting spans and counters process-wide."""
    global _COLLECT
    with _COLLECT_LOCK:
        _COLLECT = {"counters": {}, "events": [], "charged": {}}


def stop_collect() -> dict:
    """Stop collecting. Returns
    - "spans": {name: seconds}, each span's wall time summed over the
      threads that ran it (a caller waiting on a pool counts its wait);
    - "counters": the `add_count` counters, and for each span name
      `<name>.cpu_s`, the CPU seconds of the threads that worked for it:
      its own thread over it (its children there included), every
      `charge` to it or to a span under it, and the own CPU time of the
      spans under it on other threads; and `<name>.self_s`, its wall
      seconds less the part that its child spans on the same thread cover;
    - "events": one dict a span: name, id, parent, batch, thread,
      start_ns, end_ns, cpu_ns (its own thread's), self_ns."""
    global _COLLECT
    with _COLLECT_LOCK:
        d = _COLLECT
        _COLLECT = None
    if d is None:
        return {"spans": {}, "counters": {}, "events": []}
    counters = d["counters"]
    events = {e["id"]: e for e in d["events"]}
    total = {sid: e["cpu_ns"] for sid, e in events.items()}
    spans, cpu, self_ns = {}, {}, {}
    for e in events.values():
        name = e["name"]
        wall = (e["end_ns"] - e["start_ns"]) * 1e-9
        spans[name] = spans.get(name, 0.0) + wall
        self_ns[name] = self_ns.get(name, 0) + e["self_ns"]
        cpu[name] = 0
    for (sid, name), ns in d["charged"].items():
        if sid in total:
            total[sid] += ns
        else:  # to no span this collection recorded: by name alone
            cpu[name] = cpu.get(name, 0) + ns
    kids = {}
    for e in events.values():
        if e["parent"] in events:
            kids.setdefault(e["parent"], []).append(e)

    def whole(e):
        """CPU of span e and all under it: a child on e's thread is in e's
        own CPU time already, its charges and its children elsewhere not."""
        ns = total[e["id"]]
        for k in kids.get(e["id"], ()):
            ns += whole(k) - (k["cpu_ns"] if k["thread"] == e["thread"]
                              else 0)
        return ns

    for e in events.values():
        cpu[e["name"]] += whole(e)
    for name, ns in cpu.items():
        counters[name + ".cpu_s"] = ns * 1e-9
    for name, ns in self_ns.items():
        counters[name + ".self_s"] = ns * 1e-9
    return {"spans": spans, "counters": counters, "events": d["events"]}


def add_count(name: str, value) -> None:
    """Accumulate a counter (no-op unless collection is active)."""
    if _COLLECT is not None:
        with _COLLECT_LOCK:
            if _COLLECT is not None:
                c = _COLLECT["counters"]
                c[name] = c.get(name, 0) + value


def collecting() -> bool:
    """Whether spans and counters are being collected now."""
    return _COLLECT is not None


def _open_span(name: str):
    """The innermost span named `name` open in the current context, or
    None."""
    node = _CURRENT.get()
    while node is not None and node.name != name:
        node = node.parent
    return node


def _add_charge(col, key, ns: int) -> None:
    with _COLLECT_LOCK:
        if _COLLECT is col:
            ch = col["charged"]
            ch[key] = ch.get(key, 0) + ns


def _nvtx_on() -> bool:
    if _NVTX[0] is None:
        _NVTX[0] = torch.cuda.is_available()
    return _NVTX[0]


class span:
    """`with span(name):` an NVTX range, and a record while collecting.
    While open, the span is the current one of its context: its children
    and charges find it there."""
    __slots__ = ("name", "nvtx", "col", "id", "batch", "thread", "parent",
                 "child_ns", "token", "t0", "c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        col = self.col = _COLLECT
        if col is not None:
            parent = self.parent = _CURRENT.get()
            self.id = next(_IDS)
            self.batch = parent.batch if parent is not None else self.id
            self.thread = threading.get_ident()
            self.child_ns = 0  # wall time of its children on its thread
            self.token = _CURRENT.set(self)
            self.c0 = time.thread_time_ns()
            self.t0 = time.perf_counter_ns()
        nvtx = self.nvtx = _nvtx_on()
        if nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        col = self.col
        if col is None:
            return False
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.c0
        _CURRENT.reset(self.token)
        wall = t1 - self.t0
        parent = self.parent
        if parent is not None and parent.thread == self.thread:
            parent.child_ns += wall
        rec = {"name": self.name, "id": self.id,
               "parent": parent.id if parent is not None else None,
               "batch": self.batch, "thread": self.thread,
               "start_ns": self.t0, "end_ns": t1, "cpu_ns": cpu,
               "self_ns": wall - self.child_ns}
        with _COLLECT_LOCK:
            if _COLLECT is col:
                col["events"].append(rec)
        return False


class charge:
    """`with charge(name):` in a pool task adds the task thread's CPU time
    to the CPU total of span `name`, the innermost of that name that the
    task's context has open (see `bind`), while collecting. Where that span
    is open on this very thread (the task ran inline), its own record counts
    the time already, and nothing is added."""
    __slots__ = ("name", "col", "key", "c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        col = self.col = _COLLECT
        if col is not None:
            node = _open_span(self.name)
            if node is not None and node.thread == threading.get_ident():
                self.col = None
                return self
            self.key = (node.id if node is not None else None, self.name)
            self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        col = self.col
        if col is not None:
            _add_charge(col, self.key, time.thread_time_ns() - self.c0)
        return False


def charge_ns(name: str, ns: int) -> None:
    """Add `ns` of CPU time spent on threads that open no span (a native
    library's workers, which measure it only while `collecting()`) to the
    CPU total of span `name`, the innermost of that name open in the
    caller's context, while collecting."""
    col = _COLLECT
    if col is not None and ns:
        node = _open_span(name)
        _add_charge(col, (node.id if node is not None else None, name), ns)


def bind(fn):
    """`fn`, run in the caller's context wherever it is called, so that its
    spans and charges see the caller's span as theirs. While collection is
    off, `fn` itself."""
    if _COLLECT is None:
        return fn
    ctx = contextvars.copy_context()

    def bound(*args, **kwargs):
        return ctx.copy().run(fn, *args, **kwargs)

    return bound
