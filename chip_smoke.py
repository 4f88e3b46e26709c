"""Smoke test of the AIRSPACE device path on one GPU (or four).

Drives the main path once at full size through the public entry points
and compares every output byte for byte with the host codec
(engine/host.py through ``CmpContext``, itself anchored to the reference
C encoder by tests/test_oracle_parity.py).  The codec is integer-only, so
every comparison is exact.

    python chip_smoke.py           # one card: phases 1-7
    python chip_smoke.py --four    # four cards: DP, SP and chunked SP only

Exits non-zero, and prints no result line, when JAX finds no GPU or any
phase fails.  Its last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from airs_compression_tpu import (  # noqa: E402
    CmpContext,
    CmpParams,
    EncoderType,
    Preprocessing,
    decompress,
    set_timestamp_func,
)
from airs_compression_tpu.models.stream import (  # noqa: E402
    BatchCompressor,
    BatchDecompressor,
)

SEED = 20261016

# reference-recommended single-pass setting (DIFF + GOLOMB_ZERO, g=4)
RECOMMENDED = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                        primary_encoder_type=EncoderType.GOLOMB_ZERO,
                        primary_encoder_param=4, checksum_enabled=True)
# flagship multi-pass chain (the driver entry point's parameters) with the
# uncompressed fallback armed
FLAGSHIP = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                     primary_encoder_type=EncoderType.GOLOMB_ZERO,
                     primary_encoder_param=4,
                     secondary_iterations=15,
                     secondary_preprocessing=Preprocessing.MODEL,
                     secondary_encoder_type=EncoderType.GOLOMB_MULTI,
                     secondary_encoder_param=2,
                     secondary_encoder_outlier=40,
                     model_rate=8,
                     uncompressed_fallback_enabled=True)


class SmokeFailure(AssertionError):
    pass


def expect(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def detector_frames(rng, B: int, N: int, sigma: float = 4.0):
    """AIRS-like rows: a per-row baseline plus Gaussian read noise."""
    base = rng.integers(900, 1400, (B, 1))
    x = base + rng.normal(0, sigma, (B, N))
    return (x.astype(np.int64) & 0xFFFF).astype(np.uint16)


def split_stream(stream: bytes, sizes) -> "list[bytes]":
    ends = np.cumsum(sizes)
    return [stream[e - s:e] for s, e in zip(sizes.tolist(), ends.tolist())]


def offsets_of(sizes) -> np.ndarray:
    return np.concatenate(([0], np.cumsum(sizes)[:-1])).astype(np.int64)


# -- phase 1 -------------------------------------------------------------

def phase_frames(B=512, N=8192, batches=4, seed=SEED):
    """BatchCompressor.compress_frames_packed, recommended setting, with
    checksums: each stream must equal the per-block host frames."""
    rng = np.random.default_rng(seed)
    bc = BatchCompressor(RECOMMENDED, B, N)
    ctxs = [CmpContext(RECOMMENDED) for _ in range(B)]
    out = []
    for k in range(batches):
        frames = detector_frames(rng, B, N)
        stream, sizes = bc.compress_frames_packed(frames)
        ref = b"".join(c.compress_u16(f) for c, f in zip(ctxs, frames))
        expect(stream == ref, f"phase 1 batch {k}: stream != host frames")
        out.append((stream, sizes, frames))
    log(f"phase 1: {batches} x B={B} N={N} streams byte-identical "
        f"({sum(len(s) for s, _, _ in out)} bytes)")
    return out


# -- phase 2 -------------------------------------------------------------

def phase_chains(B=512, N=8192, n_frames=3, every=16, seed=SEED + 1):
    """Flagship multi-pass chains; frame 2 carries sigma=30 noise and a
    quarter of uniform-random rows (escapes and fallbacks fire)."""
    rng = np.random.default_rng(seed)
    bc = BatchCompressor(FLAGSHIP, B, N)
    ctxs = {b: CmpContext(FLAGSHIP) for b in range(0, B, every)}
    base = detector_frames(rng, B, N, sigma=2.0).astype(np.int64)
    out = []
    fell_back = 0
    for k in range(n_frames):
        sigma = 30.0 if k == 1 else 2.0
        frames = ((base + rng.normal(0, sigma, (B, N))).astype(np.int64)
                  & 0xFFFF).astype(np.uint16)
        if k == 1:
            frames[: B // 4] = rng.integers(0, 1 << 16, (B // 4, N))
        stream, sizes = bc.compress_frames_packed(frames)
        parts = split_stream(stream, sizes)
        for b, ctx in ctxs.items():
            expect(parts[b] == ctx.compress_u16(frames[b]),
                   f"phase 2 frame {k} chain {b}: device != host context")
        # a fallback frame is NONE + UNCOMPRESSED (method byte 0)
        fell_back += sum(p[15] & 0xF7 == 0 for p in parts)
        out.append((stream, sizes, frames))
    expect(fell_back >= B // 4, f"phase 2: only {fell_back} fallbacks")
    log(f"phase 2: {n_frames} frames x B={B} N={N} chains, {len(ctxs)} "
        f"checked against host contexts, {fell_back} fallback frames")
    return out


# -- phase 3 -------------------------------------------------------------

def phase_adaptive(B=512, N=8192, batches=2, seed=SEED + 2):
    """Adaptive per-block Golomb parameters; decoded later (phase 4) and
    spot-checked here with the host decoder."""
    rng = np.random.default_rng(seed)
    bc = BatchCompressor(RECOMMENDED, B, N, adaptive=True)
    out = []
    for k in range(batches):
        frames = np.concatenate([
            detector_frames(rng, B // 2, N, sigma=1.0),
            detector_frames(rng, B - B // 2, N, sigma=40.0)])
        stream, sizes = bc.compress_frames_packed(frames)
        parts = split_stream(stream, sizes)
        for b in (0, B // 2, B - 1):
            dec, _ = decompress(parts[b])
            expect(np.array_equal(dec, frames[b]),
                   f"phase 3 batch {k} block {b}: host decode mismatch")
        out.append((stream, sizes, frames))
    log(f"phase 3: {batches} x B={B} N={N} adaptive streams encoded")
    return out


# -- phase 4 -------------------------------------------------------------

def decode_streams(params, streams, B: int, N: int, what: str) -> None:
    bd = BatchDecompressor(params, B, N)
    staged = (bd.stage_frames_at(s, offsets_of(z), z) for s, z, _ in streams)
    n = 0
    for dec, (_, _, frames) in zip(bd.decompress_stream(staged), streams):
        expect(np.array_equal(dec, frames), f"phase 4 {what} batch {n}")
        n += 1
    expect(n == len(streams), f"phase 4 {what}: {n} batches decoded")


def phase_decode(recommended, chains, adaptive, B=512, N=8192,
                 B2=1024, N2=1024, seed=SEED + 3):
    decode_streams(RECOMMENDED, recommended, B, N, "recommended")
    decode_streams(FLAGSHIP, chains, B, N, "chains")
    decode_streams(RECOMMENDED, adaptive, B, N, "adaptive")
    rng = np.random.default_rng(seed)
    frames = detector_frames(rng, B2, N2)
    blobs = BatchCompressor(RECOMMENDED, B2, N2).compress_frames(frames)
    dec = BatchDecompressor(RECOMMENDED, B2, N2).decompress_frames(blobs)
    expect(np.array_equal(dec, frames), "phase 4 decompress_frames")
    log(f"phase 4: decompress_stream B={B} N={N} (recommended, chains, "
        f"adaptive) and decompress_frames B={B2} N={N2} exact, "
        f"checksums verified")


# -- phase 5 -------------------------------------------------------------

def phase_file(n_samples=32 << 20, seed=SEED + 4):
    """A big-endian u16 file through the CLI in process (-c then -d),
    against compress_chunked and the original bytes."""
    from airs_compression_tpu.cli.main import main as cli_main
    from airs_compression_tpu.cli.params_parse import params_to_string
    from airs_compression_tpu.models.chunked import compress_chunked

    rng = np.random.default_rng(seed)
    data = detector_frames(rng, 1, n_samples)[0]
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=REPO) as tmp:
        src = os.path.join(tmp, "frames.dat")
        air = os.path.join(tmp, "frames.air")
        back = os.path.join(tmp, "frames.out")
        data.astype(">u2").tofile(src)
        p = params_to_string(RECOMMENDED)
        expect(cli_main(["-c", src, "-p", p, "-o", air, "-q"]) == 0,
               "phase 5: CLI -c failed")
        with open(air, "rb") as f:
            blob = f.read()
        expect(blob == compress_chunked(RECOMMENDED, data),
               "phase 5: CLI stream != compress_chunked")
        expect(cli_main(["-d", air, "-o", back, "-q"]) == 0,
               "phase 5: CLI -d failed")
        with open(src, "rb") as a, open(back, "rb") as b:
            expect(a.read() == b.read(), "phase 5: round trip != file")
    log(f"phase 5: {2 * n_samples >> 20} MiB file via CLI -c/-d exact, "
        f"{len(blob)} bytes compressed")


# -- phase 6 -------------------------------------------------------------

def phase_long(n=1 << 22, chunk=1 << 18, seed=SEED + 5):
    """One long block on a 1-card mesh: one-shot, sidecar decode and
    chunk-fed encode, against the host codec."""
    from airs_compression_tpu.parallel.mesh import make_mesh
    from airs_compression_tpu.parallel.sp import (
        ChunkedLongStreamEncoder,
        compress_long_stream,
        decompress_long_stream,
        stream_chunk_index,
    )

    rng = np.random.default_rng(seed)
    x = detector_frames(rng, 1, n)[0]
    mesh = make_mesh(1, "sp")
    frame = compress_long_stream(mesh, RECOMMENDED, x)
    ref = CmpContext(RECOMMENDED).compress_u16(x, (1 << 24) - 1)
    expect(frame == ref,
           "phase 6: long block != host codec")
    dec = decompress_long_stream(frame, stream_chunk_index(RECOMMENDED, x))
    expect(np.array_equal(dec, x), "phase 6: sidecar decode mismatch")
    enc = ChunkedLongStreamEncoder(mesh, RECOMMENDED, n, chunk)
    enc.feed_many(x.reshape(-1, chunk))
    expect(enc.finish() == frame, "phase 6: feed_many != one-shot")
    log(f"phase 6: {n}-sample block ({len(frame)} bytes) one-shot, "
        f"sidecar decode and feed_many exact")


# -- phase 7 -------------------------------------------------------------

def median_seconds(fn, runs: int = 5):
    """Warm-up call, then the median of ``runs`` timed calls, each ended
    by block_until_ready."""
    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t)
    return statistics.median(ts), out


def compare_timed(name: str, kernel, plain, runs: int = 5) -> dict:
    tk, a = median_seconds(kernel, runs)
    tp, b = median_seconds(plain, runs)
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        expect(np.array_equal(np.asarray(u), np.asarray(v)),
               f"phase 7 {name}: kernel != plain XLA")
    log(f"phase 7 {name}: kernel {tk * 1e3:.3f} ms, plain XLA "
        f"{tp * 1e3:.3f} ms")
    return {"kernel_ms": tk * 1e3, "xla_ms": tp * 1e3}


def encoded_words(params, B: int, N: int, seed: int):
    """(cfg, words, frames) of one batch encoded on device."""
    from airs_compression_tpu.ops.encode import (
        encode_blocks_device,
        make_pass_config,
        worst_case_words,
    )

    cfg = make_pass_config(params, False, True)
    frames = detector_frames(np.random.default_rng(seed), B, N)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    z = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    words, _, _ = encode_blocks_device(cfg, None, x, x, z, zu, zu, zu,
                                       worst_case_words(cfg, N))
    return cfg, words, x


def phase_kernels(shapes=((512, 8192), (1024, 1024)), runs=5,
                  assemble_shape=(512, 8192), seed=SEED + 6,
                  interpret=False) -> dict:
    """Each kernel the GPU path keeps against its plain XLA version, and
    the two stream-assembly variants end to end.  ``interpret`` runs the
    kernels in the Pallas interpreter (CPU tests only)."""
    from airs_compression_tpu.ops.decode import decode_blocks_xla
    from airs_compression_tpu.ops.pallas_decode import decode_blocks_triton
    from airs_compression_tpu.ops.xxh32_device import (
        xxh32_blocks,
        xxh32_blocks_triton,
    )

    res = {}
    for B, N in shapes:
        cfg, words, x = encoded_words(RECOMMENDED, B, N, seed)
        res[f"decode_B{B}_N{N}"] = compare_timed(
            f"decode B={B} N={N}",
            lambda: decode_blocks_triton(cfg, words, x, N,
                                         interpret=interpret),
            lambda: decode_blocks_xla(cfg, words, x, N), runs)
        res[f"xxh32_B{B}_N{N}"] = compare_timed(
            f"xxh32 B={B} N={N}",
            lambda: xxh32_blocks_triton(x, interpret=interpret),
            lambda: xxh32_blocks(x), runs)
    B, N = assemble_shape
    frames = detector_frames(np.random.default_rng(seed), B, N)
    t = {}
    for mode in ("host", "device"):
        bc = BatchCompressor(RECOMMENDED, B, N)
        t[mode], _ = median_seconds(
            lambda: bc.compress_frames_packed(frames, assemble=mode), runs)
    ref, _ = BatchCompressor(RECOMMENDED, B, N).compress_frames_packed(
        frames, assemble="host")
    dev, _ = BatchCompressor(RECOMMENDED, B, N).compress_frames_packed(
        frames, assemble="device")
    expect(ref == dev, "phase 7: host and device assembly differ")
    log(f"phase 7 assemble B={B} N={N} (encode + assembly + fetch): host "
        f"{t['host'] * 1e3:.3f} ms, device {t['device'] * 1e3:.3f} ms")
    res[f"assemble_B{B}_N{N}"] = {"host_ms": t["host"] * 1e3,
                                  "device_ms": t["device"] * 1e3}
    return res


# -- four cards ----------------------------------------------------------

def phase_dp(n_dev=4, B=2048, N=8192, seed=SEED + 7):
    """DP encode and decode over a 4-card mesh against one card."""
    from airs_compression_tpu.ops.decode import decode_blocks_device
    from airs_compression_tpu.ops.encode import (
        encode_blocks_device,
        make_pass_config,
        worst_case_words,
    )
    from airs_compression_tpu.ops.xxh32_device import checksum_blocks_device
    from airs_compression_tpu.parallel.dp import (
        checksum_blocks_sharded,
        decode_blocks_sharded,
        encode_blocks_sharded,
    )
    from airs_compression_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_dev, "dp")
    cfg = make_pass_config(RECOMMENDED, False, True)
    nw = worst_case_words(cfg, N)
    frames = detector_frames(np.random.default_rng(seed), B, N)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    z = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    cs1 = checksum_blocks_device(x)
    w1, s1, _ = encode_blocks_device(cfg, None, x, x, z, zu, zu, cs1, nw)
    cs4 = checksum_blocks_sharded(mesh, x)
    w4, s4, _ = encode_blocks_sharded(mesh, cfg, None, x, x, z, zu, zu, cs4,
                                      nw)
    for a in (cs4, w4):
        expect(len(a.sharding.device_set) == n_dev,
               "phase dp: output not spread over the mesh")
    expect(np.array_equal(np.asarray(cs4), np.asarray(cs1)),
           "phase dp: sharded checksums != one card")
    expect(np.array_equal(np.asarray(w4), np.asarray(w1))
           and np.array_equal(np.asarray(s4), np.asarray(s1)),
           "phase dp: sharded encode != one card")
    d1, e1 = decode_blocks_device(cfg, w1, x, N)
    d4, e4 = decode_blocks_sharded(mesh, cfg, w4, x, N)
    expect(len(d4.sharding.device_set) == n_dev,
           "phase dp: decode not spread over the mesh")
    expect(np.array_equal(np.asarray(d4), np.asarray(d1))
           and np.array_equal(np.asarray(e4), np.asarray(e1))
           and np.array_equal(np.asarray(d4), np.asarray(x)),
           "phase dp: sharded decode != one card")
    log(f"phase dp: B={B} N={N} encode + decode over {n_dev} cards "
        f"identical to one card")


def phase_sp(n_dev=4, n=(1 << 23) - 4, chunk_samples=1348,
             n_chunked=1 << 22, chunk=1 << 18, seed=SEED + 8):
    """One long block split across the cards against one card."""
    from airs_compression_tpu.parallel.mesh import make_mesh
    from airs_compression_tpu.parallel.sp import (
        ChunkedLongStreamEncoder,
        compress_long_stream,
        decompress_long_stream,
        stream_chunk_index,
    )

    rng = np.random.default_rng(seed)
    x = detector_frames(rng, 1, n)[0]
    mesh4, mesh1 = make_mesh(n_dev, "sp"), make_mesh(1, "sp")
    f4 = compress_long_stream(mesh4, RECOMMENDED, x)
    f1 = compress_long_stream(mesh1, RECOMMENDED, x)
    expect(f4 == f1, "phase sp: 4-card long block != one card")
    side = stream_chunk_index(RECOMMENDED, x, chunk_samples=chunk_samples)
    expect(np.array_equal(decompress_long_stream(f4, side), x),
           "phase sp: long block decode mismatch")
    log(f"phase sp: {n}-sample block over {n_dev} cards identical to one "
        f"card, decoded exactly")
    xc = x[:n_chunked]
    one = compress_long_stream(mesh4, RECOMMENDED, xc)
    enc = ChunkedLongStreamEncoder(mesh4, RECOMMENDED, n_chunked, chunk)
    enc.feed_many(xc.reshape(-1, chunk))
    expect(enc.finish() == one, "phase sp: feed_many != one-shot")
    log(f"phase sp: feed_many {n_chunked} samples in {chunk}-sample "
        f"chunks over {n_dev} cards identical to one-shot")


# -- reporting -----------------------------------------------------------

_COMPILE_SECONDS = [0.0]


def _on_duration(event: str, seconds: float, **_kw) -> None:
    if event.endswith("backend_compile_duration"):
        _COMPILE_SECONDS[0] += seconds


def print_memory(name: str, jitted, *args, **static) -> None:
    m = jitted.lower(*args, **static).compile().memory_analysis()
    log(f"memory {name}: args {m.argument_size_in_bytes} B, out "
        f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
        f"code {m.generated_code_size_in_bytes} B")


def memory_report(B=512, N=8192) -> None:
    """compiled.memory_analysis() of each jitted device step at the
    phases' widths."""
    from airs_compression_tpu.models.stream import _decode_group_fused
    from airs_compression_tpu.ops.encode import (
        encode_blocks_device,
        make_pass_config,
        worst_case_words,
    )
    from airs_compression_tpu.ops.pallas_decode import decode_blocks_triton
    from airs_compression_tpu.ops.xxh32_device import xxh32_blocks_triton

    S = jax.ShapeDtypeStruct
    for params, name in ((RECOMMENDED, "recommended"),
                         (FLAGSHIP, "flagship")):
        for secondary in (False, True) if params is FLAGSHIP else (False,):
            cfg = make_pass_config(params, secondary, True)
            nw = worst_case_words(cfg, N)
            i32, u32 = S((B, N), jnp.int32), S((B,), jnp.uint32)
            print_memory(f"encode {name}{' secondary' * secondary}",
                         encode_blocks_device, cfg, None, i32, i32,
                         S((B,), jnp.int32), u32, u32, u32, n_words=nw)
            words = S((B, nw), jnp.uint32)
            print_memory(f"decode kernel {name}"
                         f"{' secondary' * secondary}",
                         decode_blocks_triton, cfg, words, i32, n_samples=N)
            print_memory(f"decode step {name}{' secondary' * secondary}",
                         _decode_group_fused, cfg, words, i32,
                         n_samples=N, swap=True, do_csum=cfg.checksum)
    print_memory("xxh32 kernel", xxh32_blocks_triton,
                 S((B, N), jnp.int32))


def kernel_paths(N=8192) -> str:
    from airs_compression_tpu import native
    from airs_compression_tpu.ops import routing

    p = routing.platform()
    return (f"paths: decode={routing.decode_path(p)} "
            f"checksum={routing.checksum_path(p, N)} pack=xla "
            f"assemble={routing.assemble_path(p)} "
            f"native_host={'loaded' if native.native_available() else 'MISSING'}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def run_phase(name: str, fn, *args, **kw):
    c0, t0 = _COMPILE_SECONDS[0], time.perf_counter()
    out = fn(*args, **kw)
    log(f"{name}: {time.perf_counter() - t0:.1f} s wall, "
        f"{_COMPILE_SECONDS[0] - c0:.1f} s compiling")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases (DP, SP)")
    args = ap.parse_args(argv)

    from airs_compression_tpu.utils.jaxcache import configure_compile_cache

    cache = configure_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (platform {devs[0].platform})",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: need {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    log(card_line())
    log(f"devices: {devs}")
    log(f"compile cache: {cache}")
    paths = kernel_paths()
    log(paths)
    if "MISSING" in paths:
        print("chip_smoke: native host library did not load",
              file=sys.stderr)
        return 1
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    set_timestamp_func(lambda: (0, 0))
    try:
        if args.four:
            run_phase("phase dp", phase_dp)
            run_phase("phase sp", phase_sp)
        else:
            run_phase("memory", memory_report)
            frames = run_phase("phase frames", phase_frames)
            chains = run_phase("phase chains", phase_chains)
            adaptive = run_phase("phase adaptive", phase_adaptive)
            run_phase("phase decode", phase_decode, frames, chains, adaptive)
            run_phase("phase file", phase_file)
            run_phase("phase long", phase_long)
            run_phase("phase kernels", phase_kernels)
    finally:
        set_timestamp_func(None)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
