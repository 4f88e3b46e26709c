"""Per-process program for the 2-process multi-host end-to-end test.

Run by tests/test_multihost.py in N subprocesses with a clean environment
(CPU backend, gloo cross-process collectives).  Exercises the REAL
multi-host code path the production deployment uses:

  jax.distributed.initialize (parallel.mesh.multihost_initialize)
    -> global 2-D device topology (N processes x 2 local devices)
    -> global-mesh sharded device encode (parallel.dp.encode_blocks_sharded
       semantics via make_array_from_callback + jit with NamedSharding)
    -> per-process extraction of addressable output shards
    -> cross-process size allgather (parallel.gather.allgather_sizes, host network
       analog) -> StreamManifest -> per-process shard files
    -> barrier -> process 0 splices the manifest into ONE stream, asserts
       byte-identity with the host codec (oracle-anchored) and round-trips
       it through the library decoder.

Usage: multihost_worker.py <process_id> <num_processes> <port> <tmpdir>
"""

import pathlib
import sys

PID = int(sys.argv[1])
NPROC = int(sys.argv[2])
PORT = int(sys.argv[3])
TMP = pathlib.Path(sys.argv[4])

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")

from airs_compression_tpu.parallel.mesh import multihost_initialize

multihost_initialize(coordinator_address=f"localhost:{PORT}",
                     num_processes=NPROC, process_id=PID)

import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from airs_compression_tpu import CmpParams, CmpContext, EncoderType, Preprocessing, decompress
from airs_compression_tpu.engine.context import set_timestamp_func
from airs_compression_tpu.ops.encode import (
    encode_blocks_device, make_pass_config, worst_case_words)
from airs_compression_tpu.parallel.gather import (
    StreamManifest, allgather_sizes, assemble_stream)

assert jax.process_count() == NPROC, jax.process_count()
n_dev = jax.device_count()

B, N = 16, 256
params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                   primary_encoder_type=EncoderType.GOLOMB_ZERO,
                   primary_encoder_param=4)
cfg = make_pass_config(params, False, True)
n_words = worst_case_words(cfg, N)

# every process derives the full frame set deterministically; each only
# materialises its own shard on its devices
rng = np.random.default_rng(42)
frames = ((1100 + rng.normal(0, 6, (B, N))).astype(np.int64)
          & 0xFFFF).astype(np.uint16)
x_full = frames.view(np.int16).astype(np.int32)

mesh = Mesh(np.asarray(jax.devices()), ("dp",))
s_bn = NamedSharding(mesh, P("dp", None))
s_b = NamedSharding(mesh, P("dp"))


def globalize(arr, sharding):
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx])


x = globalize(x_full, s_bn)
model = globalize(x_full, s_bn)  # ignored under DIFF
zeros_b = np.zeros((B,), np.int32)
zu = np.zeros((B,), np.uint32)
seq = globalize(zeros_b, s_b)
id_hi = globalize(zu, s_b)
id_lo = globalize(zu, s_b)
checksum = globalize(zu, s_b)

words, sizes, fell_back = encode_blocks_device(
    cfg, None, x, model, seq, id_hi, id_lo, checksum, n_words)

# ---- per-process local extraction (addressable shards, index order) ----
local = sorted(((s.index[0].start, np.asarray(s.data))
                for s in words.addressable_shards), key=lambda t: t[0])
local_rows = np.concatenate([d for _, d in local], axis=0)
local_start = local[0][0]
lsz = sorted(((s.index[0].start if s.index else 0, np.asarray(s.data))
              for s in sizes.addressable_shards), key=lambda t: t[0])
local_sizes = np.concatenate([d for _, d in lsz])

# ---- cross-process size gather + manifest ------------------------------
global_sizes = allgather_sizes(local_sizes)
assert global_sizes.shape == (B,), global_sizes.shape
blocks_per_process = [B // NPROC] * NPROC
manifest = StreamManifest(blocks_per_process, global_sizes)
assert manifest.total_bytes == int(global_sizes.sum())

# ---- per-process shard file (payload bytes never leave their host until
# the final splice) ------------------------------------------------------
shard_path = TMP / f"shard_{PID}.bin"
shard_path.write_bytes(assemble_stream(local_rows, local_sizes))
multihost_utils.sync_global_devices("shards_written")

if PID == 0:
    # splice in manifest order
    shards = [
        (TMP / f"shard_{p}.bin").read_bytes() for p in range(NPROC)]
    offsets = [0] * NPROC
    stream = bytearray()
    for p, _j, size in manifest.global_order():
        stream += shards[p][offsets[p]: offsets[p] + size]
        offsets[p] += size
    stream = bytes(stream)

    # oracle: host codec over all blocks, identifier pinned to 0 like the
    # device call
    set_timestamp_func(lambda: (0, 0))
    try:
        expect = b"".join(
            CmpContext(params).compress_u16(f) for f in frames)
    finally:
        set_timestamp_func(None)
    assert stream == expect, (
        f"spliced stream != host codec ({len(stream)} vs {len(expect)} B)")

    # round-trip through the library decoder
    decoded, hdrs = decompress(stream)
    assert len(hdrs) == B
    np.testing.assert_array_equal(
        decoded.reshape(B, N), frames)
    (TMP / "OK").write_text(
        f"procs={NPROC} devices={n_dev} blocks={B} bytes={len(stream)}")
    print(f"[0] multihost stream verified: {len(stream)} bytes, "
          f"{n_dev} devices, {NPROC} processes", flush=True)

multihost_utils.sync_global_devices("done")
