"""Spatial ("sp") parallelism for JPEG2000: tiles and rows over the mesh.

The port of nvimagecodec_tpu/parallel/tiles.py. Two shardings, both on the
product decode path (codecs/jpeg2000/core.decode_j2k(mesh=...)):

- tile-parallel: a uniform tile grid's tile axis splits over "sp", the
  analog of the modelled library's per-tile resource pool
  (extensions/nvjpeg2k/cuda_decoder.cpp:601-640). Tiles reconstruct
  independently, so no data moves between devices until the image is
  assembled on the mesh's first device.
- row-parallel: one tile's inverse DWT splits its rows over "sp"; the
  vertical lifting reads one neighbour row across each shard boundary, so
  that row is copied between the devices (ops/dwt.idwt2d_rows_sharded).
  Bit-exact vs the unsharded transform for the reversible 5/3 path.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops import dwt as dwt_ops
from .mesh import Mesh, shard_bounds


# the reference's name: the DWT ops are batch-agnostic, so [T, ...] stacked
# tile subbands go through the inverse DWT with the tile axis leading
idwt_tiles_batched = dwt_ops.idwt2d


def idwt_tiles_sharded(LL, bands, tile_shape: Tuple[int, int],
                       reversible: bool, mesh: Mesh,
                       axis_name: str = "sp") -> List[torch.Tensor]:
    """The tile axis of LL [T, ...] and of every band split into contiguous
    shards over the `axis_name` devices; each device reconstructs its own
    tiles from its own copy of their subbands (`ops/dwt.to_device`, which
    counts the bytes copied from the host), with no traffic between
    devices. Returns one [T_k, ..., th, tw] tensor per device, in tile
    order."""
    out = []
    devs = mesh.axis_devices(axis_name)
    for (lo, hi), dev in zip(shard_bounds(LL.shape[0], len(devs)), devs):
        def part(t):
            return dwt_ops.to_device(t[lo:hi], dev)

        out.append(dwt_ops.idwt2d(
            part(LL), [tuple(part(b) for b in lvl) for lvl in bands],
            tile_shape, reversible))
    return out


def dryrun_tile_exchange(mesh: Mesh) -> None:
    """Check both sp shardings on small shapes, raising on a mismatch:

    1. tile-parallel batched IDWT with the tile axis split over "sp";
    2. row-parallel IDWT of ONE tile with halo rows exchanged at the
       row-shard boundaries.

    Both must reconstruct the forward transform bit-exactly (5/3). The
    inputs are made on the host and go to the mesh's devices."""
    sp = mesh.shape["sp"]
    rng = np.random.default_rng(0)

    # 1) tile axis sharded, independent reconstruction
    T, th, tw = 2 * sp, 16, 16
    x = torch.from_numpy(rng.integers(-128, 128, (T, th, tw)).astype(np.int32))
    LL, bands = dwt_ops.dwt2d(x, 2, reversible=True)
    got = torch.cat([t.cpu() for t in idwt_tiles_sharded(
        LL, bands, (th, tw), True, mesh)])
    if not torch.equal(got, x):
        raise RuntimeError("tile-sharded IDWT differs from the input")

    # 2) one tile's rows sharded with halo exchange
    H = W = 16 * sp
    y = torch.from_numpy(rng.integers(-128, 128, (H, W)).astype(np.int32))
    LL1, bands1 = dwt_ops.dwt2d(y, 2, reversible=True)
    got1 = torch.cat([t.cpu() for t in dwt_ops.idwt2d_rows_sharded(
        LL1, bands1, (H, W), True, mesh)], dim=-2)
    if not torch.equal(got1, y):
        raise RuntimeError("row-sharded IDWT differs from the input")
