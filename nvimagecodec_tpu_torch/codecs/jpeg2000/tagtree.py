"""Tag trees (ITU-T T.800 B.10.2): 2-D hierarchical minimum coding used by
JPEG2000 packet headers for code-block inclusion and zero-bitplane counts.
Written from the spec; no reference code used."""
from __future__ import annotations

from typing import List


class TagTree:
    """Quad-tree over a w×h grid of leaves; codes per-leaf values as
    increments relative to the minimum of each parent node."""

    def __init__(self, w: int, h: int):
        self.w = w
        self.h = h
        # level 0 = leaves; each next level halves (ceil) until 1x1
        self.levels: List[tuple] = []
        lw, lh = w, h
        while True:
            self.levels.append((lw, lh))
            if lw == 1 and lh == 1:
                break
            lw = (lw + 1) // 2
            lh = (lh + 1) // 2
        self.offs = [0] * len(self.levels)  # cumulative level offsets
        acc = 0
        for l, (lw, lh) in enumerate(self.levels):
            self.offs[l] = acc
            acc += lw * lh
        n = acc
        self.value = [0] * n      # encoder: node value (min of children)
        self.low = [0] * n        # coding state: lower bound known so far
        self.coded = [False] * n  # fully coded flag
        self._paths: List = [None] * (w * h)  # per-leaf root→leaf indices

    def _index(self, level: int, x: int, y: int) -> int:
        return self.offs[level] + y * self.levels[level][0] + x

    def _path(self, x: int, y: int):
        li = y * self.w + x
        p = self._paths[li]
        if p is None:
            p = []
            lx, ly = x, y
            for level in range(len(self.levels)):
                p.append(self.offs[level] + ly * self.levels[level][0] + lx)
                lx //= 2
                ly //= 2
            p.reverse()
            self._paths[li] = p
        return p

    def reset(self) -> None:
        self.low = [0] * len(self.low)
        self.coded = [False] * len(self.coded)

    # -- encoder side -------------------------------------------------------
    def set_values(self, leaves: List[int]) -> None:
        """leaves: w*h values in raster order; builds internal minima."""
        assert len(leaves) == self.w * self.h
        vals = list(leaves)
        pos = 0
        prev = vals
        self.value[0 : self.w * self.h] = vals
        for level in range(1, len(self.levels)):
            pw, ph = self.levels[level - 1]
            lw, lh = self.levels[level]
            cur = [0] * (lw * lh)
            for y in range(lh):
                for x in range(lw):
                    best = None
                    for dy in range(2):
                        for dx in range(2):
                            cx, cy = 2 * x + dx, 2 * y + dy
                            if cx < pw and cy < ph:
                                v = prev[cy * pw + cx]
                                best = v if best is None else min(best, v)
                    cur[y * lw + x] = best if best is not None else 0
            off = self._index(level, 0, 0)
            self.value[off : off + lw * lh] = cur
            prev = cur
        self.reset()

    def encode(self, bw, x: int, y: int, threshold: int) -> None:
        """Emit bits so the decoder learns whether leaf (x,y) < threshold
        (and its exact value once reached)."""
        low = 0
        for i in self._path(x, y):
            if self.low[i] < low:
                self.low[i] = low
            v = self.value[i]
            while not self.coded[i] and self.low[i] < threshold:
                if self.low[i] == v:
                    self.coded[i] = True
                    bw.put_bit(1)
                else:
                    bw.put_bit(0)
                    self.low[i] += 1
            low = max(self.low[i], v if self.coded[i] else self.low[i])

    # -- decoder side -------------------------------------------------------
    def decode(self, br, x: int, y: int, threshold: int) -> bool:
        """Returns True iff leaf value < threshold; consumes bits
        symmetrically to encode()."""
        low = 0
        lows = self.low
        coded = self.coded
        get_bit = br.get_bit
        i = 0
        for i in self._path(x, y):
            if lows[i] < low:
                lows[i] = low
            while not coded[i] and lows[i] < threshold:
                if get_bit():
                    coded[i] = True
                else:
                    lows[i] += 1
            low = lows[i]
        # leaf decided below threshold only if its node was fully coded
        # (the last path entry IS the leaf index)
        return coded[i] and low < threshold

    def leaf_value(self, x: int, y: int) -> int:
        """Decoder: exact value of a fully-coded leaf."""
        return self.low[self._index(0, x, y)]
