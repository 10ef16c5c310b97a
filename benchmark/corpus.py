"""The general generator: a traffic file's corpus parameters and a seed in,
a pool of JPEG streams and an endless, seeded order of batches out.

Every traffic mix is data read by this one generator (`corpus` in
`traffic/<cell>.json`):

- `photos`, `photo_size` [h, w]: seeded textured photographs
  (photo.textured_photo, `texture_std`, `noise_std`);
- `streams`: the pool's size. Stream k crops its geometry from photo
  k % photos at a seeded offset;
- `geometry`: [[h, w, share], ...], and `random_share` of the pool with each
  side drawn uniformly from `random_range` [lo, hi]; counts per geometry are
  the shares of the pool rounded by largest remainder, so every seed gets
  the same mix;
- `quality`: the qualities, dealt round robin over a seeded permutation;
- `optimized_share`: the share of streams whose Huffman tables are made
  for the image (Annex K.2); the rest carry the Annex K.3 tables;
- `subsampling`: "420" or "444".

The streams are made by the benchmark's own encoder (reference/jpeg.py),
never by the measured program, on a pool of worker processes that import
nothing but NumPy and this package.
"""
from __future__ import annotations

import math
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from multiprocessing import get_context
from typing import Dict, List, Tuple

import numpy as np

from .photo import textured_photo
from .reference import jpeg


@dataclass(frozen=True)
class StreamSpec:
    photo: int
    y: int
    x: int
    height: int
    width: int
    quality: int
    optimized: bool


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), *path])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def _counts(shares: List[float], total: int) -> List[int]:
    """`total` split by `shares` (summing to 1), largest remainder."""
    raw = [s * total for s in shares]
    counts = [math.floor(r) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in order[:total - sum(counts)]:
        counts[i] += 1
    return counts


def plan(params: dict, seed: int) -> List[StreamSpec]:
    """The pool's stream specifications for `seed`."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    n = int(params["streams"])
    photos = int(params["photos"])
    ph, pw = params["photo_size"]
    fixed = params.get("geometry", [])
    rshare = float(params.get("random_share", 0.0))
    shares = [float(g[2]) for g in fixed] + ([rshare] if rshare else [])
    if abs(sum(shares) - 1.0) > 1e-6:
        raise ValueError(f"geometry shares sum to {sum(shares)}, not 1")
    geoms: List[Tuple[int, int]] = []
    for k, c in enumerate(_counts(shares, n)):
        if k < len(fixed):
            geoms += [(int(fixed[k][0]), int(fixed[k][1]))] * c
        else:
            lo, hi = params["random_range"]
            geoms += [(int(rng.integers(lo, hi + 1)),
                       int(rng.integers(lo, hi + 1))) for _ in range(c)]
    geoms = [geoms[i] for i in rng.permutation(n)]
    quals = params["quality"]
    qual_of = [int(quals[i % len(quals)]) for i in rng.permutation(n)]
    n_opt = round(float(params.get("optimized_share", 0.0)) * n)
    opt = np.zeros(n, bool)
    opt[rng.permutation(n)[:n_opt]] = True
    specs = []
    for k, (h, w) in enumerate(geoms):
        if h > ph or w > pw:
            raise ValueError(f"geometry {h}x{w} exceeds the photos {ph}x{pw}")
        specs.append(StreamSpec(k % photos, int(rng.integers(0, ph - h + 1)),
                                int(rng.integers(0, pw - w + 1)), h, w,
                                qual_of[k], bool(opt[k])))
    return specs


def _make_photo_streams(job) -> List[Tuple[int, bytes]]:
    """One photo and every stream cut from it: [(stream index, bytes)]."""
    seed, photo, (ph, pw), tex, noise, sub, items = job
    img = textured_photo(ph, pw, sub_seed(seed, 2, photo), tex, noise)
    out = []
    for k, s in items:
        crop = np.ascontiguousarray(img[s.y:s.y + s.height,
                                        s.x:s.x + s.width])
        data, _frame, _coefs = jpeg.encode(crop, s.quality, sub, s.optimized)
        out.append((k, data))
    return out


class Pending:
    """The pool for `seed`, being made: the worker processes start at once
    (`workers`: 0 for one a core less two, from 1 to 6; 1 for this
    process, at `result()`), so that the streams are made while the caller
    loads the program. `result()` waits for them; `close()` stops the
    workers and waits for them to end (a `with` block calls it).
    `seconds`: from the start to the last stream made."""

    def __init__(self, params: dict, seed: int, workers: int = 0):
        self.started = time.perf_counter()
        self.seconds = None
        self.specs = plan(params, seed)
        by_photo: Dict[int, list] = {}
        for k, s in enumerate(self.specs):
            by_photo.setdefault(s.photo, []).append((k, s))
        self.jobs = [(seed, p, tuple(params["photo_size"]),
                      params["texture_std"], params["noise_std"],
                      params.get("subsampling", "420"), items)
                     for p, items in sorted(by_photo.items())]
        workers = workers or max(1, min(6, (os.cpu_count() or 1) - 2))
        self.pool = self.futures = None
        if workers > 1:
            self.pool = ProcessPoolExecutor(workers,
                                            mp_context=get_context("spawn"))
            self.futures = [self.pool.submit(_make_photo_streams, job)
                            for job in self.jobs]
            for f in self.futures:
                f.add_done_callback(self._made)

    def _made(self, _future) -> None:
        self.seconds = time.perf_counter() - self.started

    def result(self) -> Tuple[List[StreamSpec], List[bytes]]:
        if self.futures is None:
            done = [r for job in self.jobs for r in _make_photo_streams(job)]
            self._made(None)
        else:
            done = [r for f in self.futures for r in f.result()]
        self.close()
        streams: List[bytes] = [b""] * len(self.specs)
        for k, data in done:
            streams[k] = data
        return self.specs, streams

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def make_streams(params: dict, seed: int, workers: int = 0
                 ) -> Tuple[List[StreamSpec], List[bytes]]:
    """The pool for `seed`: its specifications and its streams."""
    with Pending(params, seed, workers) as pending:
        return pending.result()


class Draws:
    """The endless order of batches: each batch `size` independent draws
    from the pool, from the seed alone."""

    def __init__(self, n_streams: int, size: int, seed: int, path: int = 3):
        self.rng = np.random.default_rng(sub_seed(seed, path))
        self.n = n_streams
        self.size = size

    def next(self) -> List[int]:
        return self.rng.integers(0, self.n, self.size).tolist()


class Sample:
    """Which outputs of a window the judge reads, from the seed alone:
    the first batch's and, of every later batch, one with chance
    1/`every`, each at a seeded position; at most `cap`, a seeded choice."""

    def __init__(self, seed: int, every: int, cap: int):
        self.rng = np.random.default_rng(sub_seed(seed, 4))
        self.seed, self.every, self.cap = seed, every, cap

    def pick(self, k: int, n: int):
        """The position judged in batch k of n outputs, or None."""
        u = self.rng.random()
        j = int(self.rng.integers(n))
        return j if k == 0 or u < 1.0 / self.every else None

    def capped(self, kept: list) -> list:
        if len(kept) <= self.cap:
            return kept
        pick = np.random.default_rng(sub_seed(self.seed, 5)).choice(
            len(kept), self.cap, replace=False)
        return [kept[i] for i in sorted(pick)]
