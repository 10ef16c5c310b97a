"""nvimagecodec_tpu_torch: the PyTorch + CUDA port of nvimagecodec_tpu.

The same Decoder/Encoder/Image/CodeStream surface as the JAX package, plus
its input pipeline (`pipeline.decode_batches`), resize ops (`ops/resize.py`)
and `imtrans`/`improc` command line (`python -m nvimagecodec_tpu_torch.cli`),
with hand-written Hopper kernels on the device path: K1 (dequant + IDCT,
csrc/idct.cu), K2 (baseline Huffman decode, csrc/huffman.cu) and K3
(progressive Huffman decode, csrc/prog_huffman.cu). The host layer (parsers,
core, native entropy and index scan, host codec plugins) is the port's own
copy, module for module under the JAX package's names. This package imports
torch, never jax and nothing of the JAX package.
"""
from .version import __version__  # noqa: F401
from .core.types import (  # noqa: F401
    Backend,
    BackendKind,
    ChromaSubsampling,
    ColorSpec,
    JpegEncoding,
    Orientation,
    Priority,
    ProcessingStatus,
    Region,
    SampleDataType,
    SampleFormat,
    Status,
)
from .core.image_info import ImageInfo, PlaneInfo  # noqa: F401
from .core.interfaces import (  # noqa: F401
    DecodeParams,
    EncodeParams,
    Jpeg2kEncodeParams,
    JpegEncodeParams,
)
from .core.code_stream import CodeStream  # noqa: F401
from .core.logger import (  # noqa: F401
    DebugMessageCategory,
    DebugMessageData,
    DebugMessageSeverity,
    register_debug_messenger,
    unregister_debug_messenger,
)
from .core.thread_pool import PriorityThreadPool  # noqa: F401
from .core.registry import CodecRegistry, global_registry  # noqa: F401
from .codecs.webp_anim import (  # noqa: F401
    decode_webp_animation,
    encode_webp_animation,
)

from .codecs import port_registry  # noqa: F401
from .api import Decoder, Encoder  # noqa: F401
from .image import Image, as_image, as_images, from_dlpack  # noqa: F401
from .codecs.jpeg.batch import configure_host_pool  # noqa: F401

__all__ = [
    "configure_host_pool",
    "__version__",
    "decode_webp_animation",
    "encode_webp_animation",
    "Backend",
    "BackendKind",
    "ChromaSubsampling",
    "CodecRegistry",
    "CodeStream",
    "ColorSpec",
    "DebugMessageCategory",
    "DebugMessageData",
    "DebugMessageSeverity",
    "DecodeParams",
    "Decoder",
    "EncodeParams",
    "Encoder",
    "PriorityThreadPool",
    "register_debug_messenger",
    "unregister_debug_messenger",
    "Image",
    "ImageInfo",
    "Jpeg2kEncodeParams",
    "JpegEncodeParams",
    "JpegEncoding",
    "Orientation",
    "PlaneInfo",
    "Priority",
    "ProcessingStatus",
    "Region",
    "SampleDataType",
    "SampleFormat",
    "Status",
    "as_image",
    "as_images",
    "from_dlpack",
    "global_registry",
    "port_registry",
]
