"""Distributed compression walkthrough: DP over a mesh + one long stream.

The reference library is single-threaded ANSI C; this example shows the
two scaling modes the JAX framework adds on top of the same bitstream
format (SURVEY.md §2.5):

1. **Data parallelism** — AIRSPACE blocks are self-delimiting, so a batch
   of frames shards over the device mesh with zero communication in the
   data path; the host assembles the concatenated stream in block order.
2. **Stream parallelism** — ONE block much longer than a chip would like
   is split along the sample axis: a `ppermute` halo feeds the DIFF
   predictor across the cut, an `all_gather` of per-shard bit lengths
   places every shard on the global bit grid, and the shards' word
   streams funnel-shift into a single format-exact payload.

Runs on any JAX platform (one or several GPUs).  To try it without GPUs:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_compression.py

On several hosts, call
``airs_compression_tpu.parallel.mesh.multihost_initialize()`` first and
shard the global batch with the same code.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

import jax
import jax.numpy as jnp

import airs_compression_tpu as act
from airs_compression_tpu.ops.encode import make_pass_config, worst_case_words
from airs_compression_tpu.parallel.dp import ShardedBatchState, encode_blocks_sharded
from airs_compression_tpu.parallel.gather import assemble_stream
from airs_compression_tpu.parallel.mesh import make_mesh
from airs_compression_tpu.parallel.sp import compress_long_stream


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")

    params = act.CmpParams(
        primary_preprocessing=act.Preprocessing.DIFF,
        primary_encoder_type=act.EncoderType.GOLOMB_ZERO,
        primary_encoder_param=4,
        checksum_enabled=True,
    )

    # ---- 1. data parallelism: a batch of frames over the mesh ----------
    mesh = make_mesh(n_dev, "dp")
    B, N = 4 * n_dev, 512
    rng = np.random.default_rng(0)
    frames = ((1100 + rng.normal(0, 6, (B, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)

    cfg = make_pass_config(params, secondary=False, unsigned_model=True)
    fb_cfg = make_pass_config(
        act.CmpParams(checksum_enabled=True), False, True)
    n_words = max(worst_case_words(cfg, N), worst_case_words(fb_cfg, N))

    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    state = ShardedBatchState(mesh, B, N)   # device-resident model state
    zeros = jnp.zeros((B,), jnp.int32)
    from airs_compression_tpu.utils.xxh32 import cmp_checksum
    csums = jnp.asarray([cmp_checksum(f) for f in frames], jnp.uint32)

    words, sizes, fell_back = encode_blocks_sharded(
        mesh, cfg, fb_cfg, x, state.model, zeros,
        zeros.astype(jnp.uint32), zeros.astype(jnp.uint32), csums, n_words)
    state.update(x, zeros, fell_back, cfg.model_rate, True)

    stream = assemble_stream(words, sizes)
    decoded, headers = act.decompress(stream)
    assert np.array_equal(decoded.reshape(B, N), frames)
    ratio = B * N * 2 / len(stream)
    print(f"DP: {B} blocks x {N} samples sharded over {n_dev} devices -> "
          f"{len(stream)} bytes ({ratio:.2f}x), round-trip exact")

    # ---- 2. stream parallelism: one long block across all devices ------
    sp_mesh = make_mesh(n_dev, "sp")
    long_stream = ((1000 + rng.normal(0, 4, 1024 * n_dev)).astype(np.int64)
                   & 0xFFFF).astype(np.uint16)
    frame = compress_long_stream(sp_mesh, params, long_stream)
    decoded, (hdr,) = act.decompress(frame)
    assert np.array_equal(decoded, long_stream)
    print(f"SP: one {long_stream.size}-sample block split over {n_dev} "
          f"devices -> {len(frame)} bytes "
          f"({long_stream.size * 2 / len(frame):.2f}x), round-trip exact")


if __name__ == "__main__":
    main()
