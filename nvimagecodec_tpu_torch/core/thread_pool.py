"""Priority thread pool with optional CPU affinity.

Counterpart of the reference's ThreadPool
(reference: src/thread_pool.cpp:127-196 — a priority work queue drained by
worker threads whose affinity is set from NVML topology / the
`<pool>_AFFINITY` env var). Here priorities order host-side work (decode
before encode, large buckets before small) and affinity pins workers via
`os.sched_setaffinity`, driven by `TPUIMGCODEC_AFFINITY` (a cpuset string
like "0-3,8").
"""
from __future__ import annotations

import heapq
import itertools
import os
import threading
from concurrent.futures import Future
from typing import Callable, Optional, Sequence


def _parse_cpuset(spec: str) -> Optional[Sequence[int]]:
    """Parse "0-3,8,10-11" into a cpu list (reference analog: the affinity
    mask parsing in src/thread_pool.cpp:147-170)."""
    cpus = []
    try:
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "-" in part:
                lo, hi = part.split("-", 1)
                cpus.extend(range(int(lo), int(hi) + 1))
            else:
                cpus.append(int(part))
    except ValueError:
        return None
    return cpus or None


class PriorityThreadPool:
    """Thread pool draining a max-priority heap; drop-in for the subset of
    ThreadPoolExecutor the schedulers use (submit/shutdown) plus a
    `priority=` kwarg — higher runs first, FIFO within a priority level
    (reference: ThreadPool::AddWork with `priority`, src/thread_pool.cpp:84-103)."""

    def __init__(
        self,
        max_workers: int,
        thread_name_prefix: str = "imgcodec",
        affinity: Optional[Sequence[int]] = None,
    ):
        self._heap: list = []  # (-priority, seq, fn, args, kwargs, future)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._shutdown = False
        if affinity is None:
            spec = os.environ.get("TPUIMGCODEC_AFFINITY", "")
            affinity = _parse_cpuset(spec) if spec else None
        self._affinity = affinity
        self._threads = [
            threading.Thread(
                target=self._worker, name=f"{thread_name_prefix}-{i}", daemon=True
            )
            for i in range(max(1, max_workers))
        ]
        for t in self._threads:
            t.start()

    # -- ThreadPoolExecutor-compatible surface --------------------------------
    def submit(self, fn: Callable, *args, priority: int = 0, **kwargs) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._shutdown:
                raise RuntimeError("cannot submit to a shut-down pool")
            heapq.heappush(self._heap, (-priority, next(self._seq), fn, args, kwargs, fut))
            self._work_ready.notify()
        return fut

    def shutdown(self, wait: bool = True, cancel_futures: bool = False) -> None:
        with self._lock:
            self._shutdown = True
            if cancel_futures:
                while self._heap:
                    *_, fut = heapq.heappop(self._heap)
                    fut.cancel()
            self._work_ready.notify_all()
        if wait:
            for t in self._threads:
                t.join()

    # -- worker ----------------------------------------------------------------
    def _worker(self) -> None:
        if self._affinity:
            try:
                os.sched_setaffinity(0, set(self._affinity))
            except (AttributeError, OSError):  # non-Linux or cpuset out of range
                pass
        while True:
            with self._lock:
                while not self._heap and not self._shutdown:
                    self._work_ready.wait()
                if not self._heap:
                    return  # shutdown with drained queue
                _, _, fn, args, kwargs, fut = heapq.heappop(self._heap)
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 - future carries it
                fut.set_exception(e)
