"""Device (batched) compress + decompress pipeline walkthrough.

The library's batched device surface: `BatchCompressor` encodes B independent
block chains per call on device; `BatchDecompressor` decodes them back,
selecting every block's decode configuration from its own header — so
uncompressed-fallback frames, mixed-phase batches, and adaptive streams
(per-block Golomb parameter) all round-trip without the caller tracking
any of it.  Whole files go through `compress_chunked`/`decompress_chunked`.

Runs on any JAX backend (CPU works; conftest-free standalone script).
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import airs_compression_tpu as act
from airs_compression_tpu.models.chunked import (
    compress_chunked,
    decompress_chunked,
)
from airs_compression_tpu.models.stream import (
    BatchCompressor,
    BatchDecompressor,
)


def main() -> int:
    params = act.CmpParams(
        primary_preprocessing=act.Preprocessing.DIFF,
        primary_encoder_type=act.EncoderType.GOLOMB_ZERO,
        primary_encoder_param=4,
        uncompressed_fallback_enabled=True,
        checksum_enabled=True,
    )

    B, N = 8, 2048
    rng = np.random.default_rng(0)
    frames = (1100 + rng.normal(0, 6, (B, N))).astype(np.int64)
    frames = (frames & 0xFFFF).astype(np.uint16)
    frames[3] = rng.integers(0, 1 << 16, N)  # noise -> falls back

    # --- batched device encode: one call, B frames ---------------------
    bc = BatchCompressor(params, B, N)
    blocks = bc.compress_frames(frames)
    for i, b in enumerate(blocks):
        hdr, _ = act.CmpHeader.deserialize(b)
        kind = "fallback" if hdr.encoder_type == 0 else "golomb"
        print(f"block {i}: {N*2} -> {len(b)} bytes ({kind})")

    # --- batched device decode: header-driven, fallback included -------
    bd = BatchDecompressor(params, B, N)
    decoded = bd.decompress_frames(blocks)
    assert np.array_equal(decoded, frames)
    print(f"\nbatch round-trip OK "
          f"({bd.metrics.gbps:.3f} GB/s decode on this backend)")

    # --- whole-file path: chunk grid, device-batched both ways ---------
    stream_data = (1100 + rng.normal(0, 8, 5 * 4096)).astype(np.int64)
    stream_data = (stream_data & 0xFFFF).astype(np.uint16)
    blob = compress_chunked(params, stream_data, chunk_samples=4096,
                            batch=4)
    restored = decompress_chunked(blob, batch=4)
    assert np.array_equal(restored, stream_data)
    print(f"chunked file round-trip OK: {stream_data.nbytes} -> "
          f"{len(blob)} bytes "
          f"({stream_data.nbytes / len(blob):.2f}x, checksums verified)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
