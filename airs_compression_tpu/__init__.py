"""airs_compression_tpu — JAX lossless compression framework for AIRS data.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the AIRSPACE
reference library (dloidolt/airs-compression): lossless compression of 16-bit
detector samples via predictive preprocessing (none / 1-D diff / integer
wavelet transform / adaptive model subtraction), zigzag mapping, and Golomb
coding with escape mechanisms, framed in the AIRSPACE bitstream format
(header spec "ARIEL-UVIE-PL-TN-004 Issue 0.2").

Unlike the reference (a sample-serial ANSI C library), the compute path here
is batch-first and vectorized: codewords for whole frames are computed in
closed form on the accelerator and bit-packed with shift-and-merge trees; blocks
are sharded data-parallel over device meshes with ``shard_map``.  This
package also implements the decoder, which the reference leaves unimplemented
(reference programs/airspacecli.c:422).

Public API mirrors the reference C API (lib/cmp.h) the Python way:

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_MULTI,
                       primary_encoder_param=4, primary_encoder_outlier=100)
    ctx = CmpContext(params)
    compressed = ctx.compress_u16(samples)     # bytes, AIRSPACE format
    samples2, info = decompress(compressed)    # the decoder the reference lacks
"""

from .format.errors import CmpError, CmpErrorCode, error_message
from .format.header import (
    CMP_CHECKSUM_SIZE,
    CMP_HDR_MAX_SIZE,
    CMP_HDR_SIZE,
    CMP_VERSION_NUMBER,
    CMP_VERSION_STRING,
    CmpHeader,
)
from .format.params import (
    CMP_MAX_MODEL_RATE,
    CmpParams,
    EncoderType,
    Preprocessing,
    cal_work_buf_size,
    compress_bound,
    uncompressed_bound,
)
from .engine.context import CmpContext, set_timestamp_func
from .engine.decode import decompress

__version__ = CMP_VERSION_STRING

__all__ = [
    "CmpParams",
    "Preprocessing",
    "EncoderType",
    "CmpContext",
    "CmpHeader",
    "CmpError",
    "CmpErrorCode",
    "compress_bound",
    "uncompressed_bound",
    "cal_work_buf_size",
    "decompress",
    "set_timestamp_func",
    "error_message",
    "CMP_HDR_SIZE",
    "CMP_HDR_MAX_SIZE",
    "CMP_CHECKSUM_SIZE",
    "CMP_VERSION_NUMBER",
    "CMP_VERSION_STRING",
    "CMP_MAX_MODEL_RATE",
    "__version__",
]
