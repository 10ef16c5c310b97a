"""Several devices: meshes, J2K tile and row sharding, and processes.

The port of nvimagecodec_tpu/parallel/. Batches shard over the "dp" axis of
a mesh (`Decoder(mesh=)`, `GenericEncoder(mesh=)`, `decode_batches(mesh=)`),
J2K tiles and the rows of one tile's inverse DWT over "sp" (`tiles.py`,
`ops/dwt.idwt2d_rows_sharded`), all from one process over a list of
devices; `multihost.py` spreads streams over processes with
torch.distributed.
"""
from .mesh import Mesh, batch_sharding, make_mesh  # noqa: F401
