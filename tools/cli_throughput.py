"""Measure the CLI's chunked device path vs the host codec on a big file.

The CLI routes any file beyond the single-block format limit (16 MiB packed)
through models/chunked.compress_chunked -> BatchCompressor on the device.
This harness times that path against the pure host codec on the same
data and asserts the outputs are equivalent streams (byte-identical when
the chunk grid matches, which it does — both sides use the same grid).

Usage:  python tools/cli_throughput.py [size_mib] [chunk_samples] [batch]
"""

import pathlib
import sys
import time

import jax
import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from airs_compression_tpu.utils.jaxcache import configure_compile_cache

configure_compile_cache()

from airs_compression_tpu import CmpContext, CmpParams, EncoderType, Preprocessing
from airs_compression_tpu import set_timestamp_func
from airs_compression_tpu.engine.decode import decompress
from airs_compression_tpu.models.chunked import (
    DEFAULT_BATCH,
    DEFAULT_CHUNK_SAMPLES,
    compress_chunked,
)


def main():
    size_mib = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else DEFAULT_CHUNK_SAMPLES
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else DEFAULT_BATCH
    n = size_mib * (1 << 20) // 2
    print(f"devices: {jax.devices()}", file=sys.stderr)
    rng = np.random.default_rng(0)
    data = ((1100 + rng.normal(0, 6, n)).astype(np.int64)
            & 0xFFFF).astype(np.uint16)
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4)
    set_timestamp_func(lambda: (0, 0))
    gb = data.nbytes / 1e9

    # warm up compiles outside the timed run (steady-state throughput)
    compress_chunked(params, data[: 2 * batch * chunk], chunk_samples=chunk,
                     batch=batch)
    t0 = time.perf_counter()
    dev_blob = compress_chunked(params, data, chunk_samples=chunk,
                                batch=batch)
    t_dev = time.perf_counter() - t0
    print(f"device chunked path: {t_dev:.3f}s -> {gb / t_dev:.2f} GB/s "
          f"(ratio {data.nbytes / len(dev_blob):.2f}x)")

    # host path on the same chunk grid (the reference one-context run)
    ctx = CmpContext(params)
    t0 = time.perf_counter()
    host_parts = [ctx.compress_u16(data[i : i + chunk])
                  for i in range(0, n, chunk)]
    t_host = time.perf_counter() - t0
    host_blob = b"".join(host_parts)
    print(f"host codec path:     {t_host:.3f}s -> {gb / t_host:.2f} GB/s")
    print(f"device speedup: {t_host / t_dev:.1f}x")

    assert len(dev_blob) == len(host_blob), "stream sizes differ"
    # identifiers are stubbed identically -> full byte parity expected
    assert dev_blob == host_blob, "device stream != host stream"
    from airs_compression_tpu.format.header import CmpHeader

    hdr, _ = CmpHeader.deserialize(dev_blob)
    dec, _ = decompress(dev_blob[: hdr.compressed_size])
    assert np.array_equal(dec, data[:chunk])
    print("parity + round-trip OK")

    # --- decompression: device chunked path vs host per-block decode ----
    from airs_compression_tpu.models.chunked import decompress_chunked

    # warm the decode compile outside the timed run
    warm = b"".join(host_parts[: min(2 * batch, len(host_parts))])
    decompress_chunked(warm, batch=batch)
    t0 = time.perf_counter()
    out_dev = decompress_chunked(dev_blob, batch=batch)
    t_ddev = time.perf_counter() - t0
    assert np.array_equal(out_dev, data), "device decompress mismatch"
    print(f"device decompress:   {t_ddev:.3f}s -> {gb / t_ddev:.2f} GB/s")

    # host decode rate measured on a prefix (it is the slow path)
    host_mib = min(size_mib, 32)
    n_host_blocks = max(1, host_mib * (1 << 20) // (2 * chunk))
    prefix = b"".join(host_parts[:n_host_blocks])
    prefix_bytes = n_host_blocks * chunk * 2
    t0 = time.perf_counter()
    out_h, _ = decompress(prefix)
    t_dhost = time.perf_counter() - t0
    assert np.array_equal(out_h, data[: n_host_blocks * chunk])
    host_gbps = prefix_bytes / t_dhost / 1e9
    print(f"host decompress:     {t_dhost:.3f}s on {host_mib} MiB -> "
          f"{host_gbps:.3f} GB/s")
    print(f"device decode speedup: {gb / t_ddev / host_gbps:.1f}x")
    set_timestamp_func(None)


if __name__ == "__main__":
    main()
