"""Device meshes and the tensor splits over them.

The port of nvimagecodec_tpu/parallel/mesh.py. A mesh is a `dp x sp` array
of `torch.device`s with the reference's axes:

- "dp": data parallel over the images of a batch (the analog of the
  modelled library's executor fan-out over samples,
  src/default_executor.cpp:45-65);
- "sp": spatial parallel within one image: JPEG2000 tiles, or the rows of
  one tile's inverse DWT (the analog of the J2K tile-resource pool,
  extensions/nvjpeg2k/cuda_decoder.cpp:601-640).

One process drives every device of the mesh: `Decoder(mesh=)` takes one
batch from one caller and returns every image, like the reference's
single-controller `jax.sharding.Mesh`. `torch.distributed.DeviceMesh` is one
process per device and cannot describe that; work across processes is
`multihost.py`'s. A device may appear more than once (the CPU tests use
`[torch.device("cpu")] * 8`): a shard on the same device as another is still
a shard of its own, computed and moved like any other.

`batch_sharding`, `plane_sharding` and `replicated` keep the reference's
names; where the reference returns a sharding for `jax.device_put`, these
split a tensor (or copy it) and return one tensor per device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("dp", "sp")


class Mesh:
    """`devices[i][j]` is the device of dp index i, sp index j."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh needs a non-empty rectangle of devices")
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(r) for r in rows)
        self.axis_names = AXES
        self.shape: Dict[str, int] = {"dp": len(rows), "sp": len(rows[0])}

    @property
    def first_device(self) -> torch.device:
        """Where a sharded result is assembled."""
        return self.devices[0][0]

    def flat_devices(self) -> List[torch.device]:
        """Every device, dp-major (the order of `plane_sharding`)."""
        return [d for row in self.devices for d in row]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along one axis at index 0 of the other: the dp shards
        of a batch, or the sp shards of an image."""
        if axis == "dp":
            return [row[0] for row in self.devices]
        if axis == "sp":
            return list(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}")


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("dp", "sp") mesh over `devices`, by default every visible
    CUDA device (never the CPU by detection). dp defaults to
    len(devices) // sp; the first dp * sp devices are used, dp-major."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "to build a mesh over")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if dp is None:
        dp = len(devs) // sp
    if dp < 1 or sp < 1 or dp * sp > len(devs):
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} of the "
                         f"{len(devs)} devices given")
    return Mesh([devs[i * sp:(i + 1) * sp] for i in range(dp)])


def shard_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of `parts` contiguous shards of n items, the first n % parts
    one longer (as `torch.tensor_split`); a shard may be empty."""
    base, extra = divmod(n, parts)
    out, lo = [], 0
    for k in range(parts):
        hi = lo + base + (k < extra)
        out.append((lo, hi))
        lo = hi
    return out


def _split_to(x: torch.Tensor, dim: int,
              devices: Sequence[torch.device]) -> List[torch.Tensor]:
    return [x.narrow(dim, lo, hi - lo).to(d, non_blocking=True)
            for (lo, hi), d in zip(shard_bounds(x.shape[dim], len(devices)),
                                   devices)]


def batch_sharding(x: torch.Tensor, mesh: Mesh,
                   batch_axis: int = 0) -> List[torch.Tensor]:
    """Split `batch_axis` over the "dp" devices (contiguous, uneven allowed);
    one tensor per dp device, replicated over "sp"."""
    return _split_to(x, batch_axis, mesh.axis_devices("dp"))


def plane_sharding(x: torch.Tensor, mesh: Mesh,
                   batch_axis: bool = True) -> List[torch.Tensor]:
    """[B, H, W...] with the batch on "dp" and the rows on "sp": one tensor
    per device of the mesh, dp-major. With batch_axis=False, [H, W...] with
    the rows on "sp": one tensor per sp device."""
    if not batch_axis:
        return _split_to(x, 0, mesh.axis_devices("sp"))
    out = []
    for part, row in zip(_split_to(x, 0, mesh.axis_devices("dp")),
                         mesh.devices):
        out.extend(_split_to(part, 1, row))
    return out


def replicated(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A copy of x on every device of the mesh, dp-major."""
    return [x.to(d, non_blocking=True) for d in mesh.flat_devices()]
