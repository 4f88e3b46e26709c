"""Benchmark: on-device AIRSPACE encode/decode throughput on one GPU.

Measures the fused device encoder (preprocess -> Golomb codewords ->
doubling-tree bit-pack -> framed stream) and the lockstep decoder (the
Triton kernel, ops/pallas_decode.py) on AIRS-like detector frames with
the headline config (DIFF + GOLOMB_ZERO, the reference's recommended
science setup).

Prints ONE JSON line to stdout (as the last line):
    {"metric": "encode_gbps_per_chip", "value": N, "unit": "GB/s",
     "vs_baseline": R, "decode_gbps": D, "ratio": C,
     "hw_verified_configs": K, "platform": "gpu", "device_kind": ...,
     "device_count": 1}

``vs_baseline``: the reference publishes no numbers, so this repo
established the baseline itself: the unmodified reference C encoder at
gcc -O3 runs 0.173 GB/s on one CPU core for this exact workload and
config (identical output bytes).  vs_baseline = value / 0.173.

Method:

* Each timed device stage runs ONE jitted program whose measurement loop
  takes the trip count as a *traced* argument (lax.fori_loop with
  dynamic bounds), so the same compiled program serves the correctness
  gate (n_iter=1 returns the exact frames) and both timing points; the
  per-iteration time is the difference of two trip counts.
* Correctness gates run before any number is accepted: encoded frames
  must be byte-identical to the host codec (itself differential-tested
  against the unmodified reference C library), and the timed decoder must
  round-trip.  A failed gate or stage fails the run (non-zero exit, no
  result line): a fast-but-wrong kernel never posts a number.
* The run needs a GPU; it refuses to measure anything else.  The
  persistent compile cache follows utils/jaxcache.py.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

T0 = time.time()
REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax
import jax.numpy as jnp

from airs_compression_tpu.utils.jaxcache import configure_compile_cache  # noqa: E402

_CACHE = configure_compile_cache()

from airs_compression_tpu.format.params import CmpParams, EncoderType, Preprocessing
from airs_compression_tpu.ops.encode import (
    _encode_one_pass,
    make_pass_config,
    worst_case_words,
)

REFERENCE_C_GBPS = 0.173  # reference encoder, gcc -O3, 1 CPU core (CPU number)

# Total wall budget; optional stages check remaining() before starting.
DEADLINE_S = float(os.environ.get("AIRS_BENCH_DEADLINE", "2400"))

RESULT = {"metric": "encode_gbps_per_chip", "value": 0.0, "unit": "GB/s",
          "vs_baseline": 0.0}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class GateFailure(RuntimeError):
    """A correctness gate failed: the run must not post a number."""


def fail(msg):
    raise GateFailure(msg)


def remaining() -> float:
    return DEADLINE_S - (time.time() - T0)


def timed(fn, *args):
    t0 = time.time()
    out = fn(*args)
    out = jax.tree_util.tree_map(np.asarray, out)
    return time.time() - t0, out


def headline_params() -> CmpParams:
    return CmpParams(primary_preprocessing=Preprocessing.DIFF,
                     primary_encoder_type=EncoderType.GOLOMB_ZERO,
                     primary_encoder_param=4)


def make_frames(B, N, seed=0):
    rng = np.random.default_rng(seed)
    return ((1100 + rng.normal(0, 6, (B, N))).astype(np.int64)
            & 0xFFFF).astype(np.uint16)


def make_encode_loop(cfg, n_words, B, N, cap_bits=None):
    """One program: dynamic-trip-count serial encode loop.

    Returns (acc, words, sizes, pack_ok) of the final iteration.
    Iteration 0 sees the unmodified input (carry starts at 0), so n_iter=1
    yields the exact encoder output for the correctness gate; larger
    n_iter chains a serial data dependency (flip bit 0 of every sample by
    a parity of the prior output) so XLA cannot collapse the loop.
    ``cap_bits`` marks ``n_words`` as entropy-clamped; the gate checks
    ``pack_ok`` so a clamp overflow can never post a number.
    """
    seq = jnp.zeros((B,), jnp.int32)
    ids = jnp.zeros((B,), jnp.uint32)
    csum = jnp.zeros((B,), jnp.uint32)

    @jax.jit
    def loop(x, n_iter):
        def body(i, carry):
            acc = carry[0]
            x2 = x ^ (acc[:, None] & jnp.int32(1))
            if cap_bits is not None:
                words, sizes, ok = _encode_one_pass(
                    cfg, x2, x2, seq, ids, ids, csum, n_words,
                    cap_bits=cap_bits)
            else:
                words, sizes = _encode_one_pass(cfg, x2, x2, seq, ids, ids,
                                                csum, n_words)
                ok = jnp.ones((B,), bool)
            acc2 = (jnp.sum(words, axis=-1, dtype=jnp.uint32)
                    .astype(jnp.int32) + sizes + ok.astype(jnp.int32))
            return (acc2, words, sizes, ok)

        init = (jnp.zeros((B,), jnp.int32),
                jnp.zeros((B, n_words), jnp.uint32),
                jnp.zeros((B,), jnp.int32),
                jnp.ones((B,), bool))
        return jax.lax.fori_loop(0, n_iter, body, init)

    return loop


def measure_loop(loop_fn, first_arg, n_lo, n_hi, reps=5):
    """Median per-iteration time via two-trip-count differencing (the
    dispatch and fetch cost cancels in the difference)."""
    samples = []
    for _ in range(reps):
        t_lo, _ = timed(lambda: loop_fn(first_arg, n_lo)[0])
        t_hi, _ = timed(lambda: loop_fn(first_arg, n_hi)[0])
        samples.append(max((t_hi - t_lo) / (n_hi - n_lo), 1e-9))
        log(f"  lo={t_lo*1e3:.1f}ms hi={t_hi*1e3:.1f}ms -> "
            f"{samples[-1]*1e3:.3f} ms/iter")
    return sorted(samples)[len(samples) // 2]


def stage_encode():
    """Headline encode number + byte-exactness gate.  Returns handles."""
    from airs_compression_tpu.ops.encode import default_cap_bits

    from airs_compression_tpu.ops.encode import clamped_frame_words

    B, N = 512, 8192
    params = headline_params()
    cfg = make_pass_config(params, False, True)
    n_words_full = worst_case_words(cfg, N)
    frames = make_frames(B, N)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)

    cap = default_cap_bits(cfg)
    # entropy-sized frame buffer: valid whenever pack_ok holds (gated below)
    n_words = clamped_frame_words(cfg, N, cap)
    log(f"encode pack cap_bits={cap} (worst {cfg.worst_bits_per_sample}), "
        f"frame words {n_words} (worst {n_words_full})")
    loop = make_encode_loop(cfg, n_words, B, N, cap_bits=cap)
    log("compiling encode loop...")
    t0 = time.time()
    _, words, sizes, pack_ok = jax.tree_util.tree_map(np.asarray, loop(x, 1))
    log(f"encode loop compiled+ran in {time.time()-t0:.1f}s")
    if cap is not None and not pack_ok.all():
        log(f"entropy clamp overflowed {int((~pack_ok).sum())} blocks; "
            "recompiling at full capacity")
        cap = None
        n_words = n_words_full
        loop = make_encode_loop(cfg, n_words, B, N)
        _, words, sizes, pack_ok = jax.tree_util.tree_map(np.asarray,
                                                          loop(x, 1))
    RESULT["pack_cap_bits"] = cap

    # correctness gate: device frames byte-identical to the host codec
    from airs_compression_tpu.engine.context import CmpContext, set_timestamp_func

    set_timestamp_func(lambda: (0, 0))
    try:
        for i in range(4):
            ref = CmpContext(params).compress_u16(frames[i])
            dev = words[i].astype(">u4").tobytes()[: int(sizes[i])]
            if dev != ref:
                fail(f"device frame {i} != host codec")
    finally:
        set_timestamp_func(None)
    log("correctness gate: device frames byte-identical to host codec")

    gb = B * N * 2 / 1e9
    per_iter = measure_loop(loop, x, 1, 2049, 5)
    gbps = gb / per_iter
    ratio = float(B * N * 2) / float(sizes.sum())
    log(f"encode B={B} N={N}: {per_iter*1e3:.3f} ms/iter -> {gbps:.2f} GB/s"
        f" (ratio {ratio:.2f}x)")
    RESULT["value"] = round(gbps, 3)
    RESULT["vs_baseline"] = round(gbps / REFERENCE_C_GBPS, 3)
    RESULT["ratio"] = round(ratio, 3)


def stage_encode_csum():
    """Checksum-enabled encode: XXH32 on device inside the timed loop.

    The reference computes the checksum inline in the engine
    (lib/compress/cmp.c:314-319); round 2 did it host-serially and only
    timed csum=0.  Target: within ~15% of the csum=0 headline.
    """
    import dataclasses

    from airs_compression_tpu.ops.encode import clamped_frame_words, default_cap_bits
    from airs_compression_tpu.ops.xxh32_device import checksum_blocks_device

    B, N = 512, 8192
    params = dataclasses.replace(headline_params(), checksum_enabled=True)
    cfg = make_pass_config(params, False, True)
    cap = default_cap_bits(cfg)
    n_words = clamped_frame_words(cfg, N, cap)
    frames = make_frames(B, N, seed=2)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    seq = jnp.zeros((B,), jnp.int32)
    ids = jnp.zeros((B,), jnp.uint32)

    @jax.jit
    def loop(x, n_iter):
        def body(i, carry):
            acc = carry[0]
            x2 = x ^ (acc[:, None] & jnp.int32(1))
            csum = checksum_blocks_device(x2)
            if cap is not None:
                words, sizes, ok = _encode_one_pass(
                    cfg, x2, x2, seq, ids, ids, csum, n_words, cap_bits=cap)
            else:
                words, sizes = _encode_one_pass(cfg, x2, x2, seq, ids, ids,
                                                csum, n_words)
                ok = jnp.ones((B,), bool)
            acc2 = (jnp.sum(words, axis=-1, dtype=jnp.uint32)
                    .astype(jnp.int32) + sizes + ok.astype(jnp.int32))
            return (acc2, words, sizes, ok)

        init = (jnp.zeros((B,), jnp.int32),
                jnp.zeros((B, n_words), jnp.uint32),
                jnp.zeros((B,), jnp.int32),
                jnp.ones((B,), bool))
        return jax.lax.fori_loop(0, n_iter, body, init)

    log("compiling csum encode loop...")
    t0 = time.time()
    _, words, sizes, pack_ok = jax.tree_util.tree_map(np.asarray, loop(x, 1))
    log(f"csum encode loop compiled+ran in {time.time()-t0:.1f}s")
    if cap is not None and not pack_ok.all():
        log("csum stage: clamp overflowed, skipping (headline covers clamp)")
        return

    from airs_compression_tpu.engine.context import CmpContext, set_timestamp_func

    set_timestamp_func(lambda: (0, 0))
    try:
        for i in range(2):
            ref = CmpContext(params).compress_u16(frames[i])
            dev = words[i].astype(">u4").tobytes()[: int(sizes[i])]
            if dev != ref:
                fail("csum frames != host codec")
    finally:
        set_timestamp_func(None)
    log("correctness gate: csum=1 device frames byte-identical to host")

    gb = B * N * 2 / 1e9
    per_iter = measure_loop(loop, x, 1, 1025, 3)
    gbps = gb / per_iter
    log(f"csum encode B={B} N={N}: {per_iter*1e3:.3f} ms/iter -> "
        f"{gbps:.2f} GB/s ({100*gbps/max(RESULT['value'],1e-9):.0f}% of "
        "csum=0)")
    RESULT["csum_encode_gbps"] = round(gbps, 3)


def stage_flagship():
    """Realistic flagship config: secondary MODEL+MULTI pass with the
    uncompressed fallback armed (full airspacecli parity),
    quantifying the dual-encode fallback cost (ops/encode.py:380-396)."""
    import dataclasses

    from airs_compression_tpu.ops.encode import encode_blocks_device, model_update_step

    B, N = 512, 8192
    import __graft_entry__ as ge

    from airs_compression_tpu.ops.encode import clamped_frame_words, default_cap_bits

    params = dataclasses.replace(ge._flagship_params(),
                                 uncompressed_fallback_enabled=True)
    cfg_s = make_pass_config(params, True, True)
    fb_params = dataclasses.replace(
        params, primary_preprocessing=Preprocessing.NONE,
        primary_encoder_type=EncoderType.UNCOMPRESSED)
    fb_cfg = make_pass_config(fb_params, False, True)
    # entropy-clamped buffers (MULTI's 48-bit worst case would otherwise
    # triple the tree; the class-aware cap + narrow path shrink it
    # further); the frame buffer must still hold an uncompressed
    # fallback frame, and pack_ok gates the number
    cap = default_cap_bits(cfg_s)
    n_words = max(clamped_frame_words(cfg_s, N, cap),
                  worst_case_words(fb_cfg, N))
    assert 16 + 2 * N <= n_words * 4, "fallback frame must fit"

    rng = np.random.default_rng(3)
    base = make_frames(B, N, seed=3)
    frames = ((base.astype(np.int64) + rng.integers(-2, 3, (B, N)))
              & 0xFFFF).astype(np.uint16)
    model = jnp.asarray(base.view(np.int16), jnp.int32)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    seq = jnp.ones((B,), jnp.int32)
    ids = jnp.zeros((B,), jnp.uint32)
    csum = jnp.zeros((B,), jnp.uint32)

    @jax.jit
    def loop(x, n_iter):
        def body(i, carry):
            acc = carry[0]
            x2 = x ^ (acc[:, None] & jnp.int32(1))
            if cap is not None:
                words, sizes, fell, ok = encode_blocks_device(
                    cfg_s, fb_cfg, x2, model, seq, ids, ids, csum, n_words,
                    cap_bits=cap)
            else:
                words, sizes, fell = encode_blocks_device(
                    cfg_s, fb_cfg, x2, model, seq, ids, ids, csum, n_words)
                ok = jnp.ones((B,), bool)
            m2 = model_update_step(x2, model, seq, fell,
                                   cfg_s.model_rate, True)
            acc2 = (jnp.sum(words, axis=-1, dtype=jnp.uint32)
                    .astype(jnp.int32) + sizes + ok.astype(jnp.int32)
                    + jnp.sum(m2, axis=-1, dtype=jnp.int32))
            return (acc2, words, sizes, fell, ok)

        init = (jnp.zeros((B,), jnp.int32),
                jnp.zeros((B, n_words), jnp.uint32),
                jnp.zeros((B,), jnp.int32),
                jnp.zeros((B,), bool),
                jnp.ones((B,), bool))
        return jax.lax.fori_loop(0, n_iter, body, init)

    log("compiling flagship loop...")
    t0 = time.time()
    _, words, sizes, fell, pack_ok = jax.tree_util.tree_map(np.asarray, loop(x, 1))
    log(f"flagship loop compiled+ran in {time.time()-t0:.1f}s "
        f"(fallbacks: {int(fell.sum())}/{B})")
    if not pack_ok.all():
        log("flagship: entropy clamp overflowed; skipping timed point")
        return

    # gate: host context runs the primary pass on `base`, then the
    # secondary pass on `frames` — device bytes must match pass 2
    from airs_compression_tpu.engine.context import CmpContext, set_timestamp_func

    set_timestamp_func(lambda: (0, 0))
    try:
        for i in range(2):
            ctx = CmpContext(params)
            ctx.compress_u16(base[i])
            ref = ctx.compress_u16(frames[i])
            dev = words[i].astype(">u4").tobytes()[: int(sizes[i])]
            if dev != ref:
                fail("flagship secondary != host codec")
    finally:
        set_timestamp_func(None)
    log("correctness gate: flagship secondary frames byte-identical")

    gb = B * N * 2 / 1e9
    per_iter = measure_loop(loop, x, 1, 513, 3)
    gbps = gb / per_iter
    log(f"flagship encode B={B} N={N}: {per_iter*1e3:.3f} ms/iter -> "
        f"{gbps:.2f} GB/s")
    RESULT["flagship_encode_gbps"] = round(gbps, 3)


def stage_sp():
    """Long-stream (context-parallel) path on real hardware: one 2^21-
    sample block through parallel/sp.py on a 1-device mesh — encode AND
    sidecar chunk-parallel decode.

    The encode number now covers COMPLETE frame production on device
    (shard encode + span scatter-merge + header words,
    parallel/sp._sp_frame_program); the only host steps left are the
    size fetch and byte slice.  The mesh here is 1 device, so no
    cross-card halo or all_gather cost is inside the number — recorded
    in the artifact as sp_mesh_devices.
    """
    from jax.sharding import Mesh

    from airs_compression_tpu.engine.context import CmpContext, set_timestamp_func
    from airs_compression_tpu.ops.encode import make_pass_config as _mpc
    from airs_compression_tpu.parallel.sp import (
        _sidecar_decode_device,
        _sp_frame_program,
        compress_long_stream,
        decompress_long_stream,
        stream_chunk_index,
    )

    # 2^21 samples: the largest power of two whose WORST-CASE bound still
    # fits the 24-bit compressed_size field (cmp_compress_bound rejects
    # 2^22 even though the actual frame would fit — reference cmp.c:59-74)
    n = 1 << 21
    params = headline_params()
    rng = np.random.default_rng(4)
    data = ((1100 + rng.normal(0, 6, n)).astype(np.int64)
            & 0xFFFF).astype(np.uint16)
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    cfg = _mpc(params, False, True)
    RESULT["sp_mesh_devices"] = mesh.devices.size
    log("compiling SP whole-frame program...")
    t0 = time.time()
    run = _sp_frame_program(mesh, cfg, n, False)
    x_dev = jnp.asarray(data.view(np.int16), jnp.int32)
    out_words, size_dev, _ = jax.block_until_ready(run(x_dev, 0, 0, 0))
    log(f"SP whole-frame program compiled+ran in {time.time()-t0:.1f}s")

    @jax.jit
    def enc_loop(x, n_iter):
        def body(i, carry):
            acc = carry[0]
            x2 = x ^ (acc & jnp.int32(1))
            words, size, _pb = run(x2, 0, 0, 0)
            return (acc + size.astype(jnp.int32)
                    + jnp.sum(words, dtype=jnp.uint32).astype(jnp.int32)
                    + jnp.int32(1), words, size)

        init = (jnp.int32(0), jnp.zeros_like(out_words), jnp.int32(0))
        return jax.lax.fori_loop(0, n_iter, body, init)

    log("compiling SP encode loop...")
    t0 = time.time()
    (jax.block_until_ready(enc_loop(x_dev, 1)[0]))
    log(f"SP encode loop compiled+ran in {time.time()-t0:.1f}s")
    per = measure_loop(enc_loop, x_dev, 1, 129, 3)
    gbps = 2 * n / per / 1e9

    # --- sidecar chunk-parallel decode of the same frame.  The decode
    # program consumes the device-resident frame words from the encode
    # program's output.
    from airs_compression_tpu.ops.encode import PassConfig
    from airs_compression_tpu.parallel.sp import _chunk_bits_device

    chunk = 1024
    n_chunks = n // chunk
    # chunk-decode config: entropy params from the frame, NO
    # preprocessing (the inverse runs over the FULL stream after the
    # lanes decode — same construction as decompress_long_stream)
    dcfg = PassConfig(0, cfg.enc_type, cfg.g_par, cfg.outlier,
                      False, 0, False, True)
    hb = dcfg.hdr_bits
    # exact-sized window, same as the wrapper
    max_bits = int(np.asarray(
        _chunk_bits_device(cfg, x_dev[None], chunk)).max())
    max_bits = min(max_bits, chunk * dcfg.worst_bits_per_sample)
    c_lane = (hb + max_bits + 63) // 32 + 2

    @jax.jit
    def sidecar_loop(words_frame, x_in, n_iter):
        # sidecar build ON DEVICE (exclusive cumsum of per-chunk bit
        # sums), then the window + lockstep decode; trip-count
        # differencing cancels the dispatch floor like every other
        # timed stage
        bits = _chunk_bits_device(cfg, x_in[None], chunk)
        start = (jnp.cumsum(bits) - bits).astype(jnp.int32)

        def body(i, carry):
            acc, s_prev, e_prev = carry
            w2 = words_frame ^ (acc & jnp.uint32(1))
            s, e = _sidecar_decode_device(dcfg, w2, start, chunk,
                                          c_lane, cfg.prep, n)
            # acc ACCUMULATES (+1) so no iteration ever repeats a
            # prior carry bit-for-bit: a fixpoint carry lets the
            # compiled loop skip work (observed: 65 trips timed as 1)
            return (acc + jnp.sum(e).astype(jnp.uint32)
                    + jnp.uint32(1), s, e)

        init = (jnp.uint32(0), jnp.zeros((n,), jnp.int32),
                jnp.zeros((n_chunks,), jnp.int32))
        return jax.lax.fori_loop(0, n_iter, body, init), bits
    log(f"compiling sidecar decode loop ("
        f"{n_chunks} lanes x {chunk})...")
    t0 = time.time()
    (_, dec_samples, dec_end), bits_dev = jax.block_until_ready(
        sidecar_loop(out_words, x_dev, 1))
    log(f"sidecar decode loop compiled+ran in {time.time()-t0:.1f}s")
    # timing: same two-trip-count differencing as the kernel stages
    samples = []
    for _ in range(3):
        t_lo = time.time()
        np.asarray(sidecar_loop(out_words, x_dev, 1)[0][0])
        t_lo = time.time() - t_lo
        t_hi = time.time()
        np.asarray(sidecar_loop(out_words, x_dev, 129)[0][0])
        t_hi = time.time() - t_hi
        samples.append(max((t_hi - t_lo) / 128, 1e-9))
        log(f"  sp-decode lo={t_lo*1e3:.1f}ms hi={t_hi*1e3:.1f}ms -> "
            f"{samples[-1]*1e3:.3f} ms/iter")
    per_d = sorted(samples)[1]

    # sidecar BUILD cost (the codeword-length pass), same methodology
    @jax.jit
    def build_loop(x_in, n_iter):
        def body(i, acc):
            b = _chunk_bits_device(
                cfg, (x_in ^ (acc & jnp.int32(1)))[None], chunk)
            return acc + jnp.sum(b).astype(jnp.int32) + jnp.int32(1)

        return jax.lax.fori_loop(0, n_iter, body, jnp.int32(0))

    np.asarray(build_loop(x_dev, 1))
    t_lo = time.time()
    np.asarray(build_loop(x_dev, 1))
    t_lo = time.time() - t_lo
    t_hi = time.time()
    np.asarray(build_loop(x_dev, 129))
    t_hi = time.time() - t_hi
    RESULT["sp_sidecar_build_ms"] = round(
        max((t_hi - t_lo) / 128, 1e-9) * 1e3, 3)
    log(f"sidecar build: {RESULT['sp_sidecar_build_ms']} ms")

    # gate: full frame must be byte-identical to the host codec
    frame = compress_long_stream(mesh, params, data)
    set_timestamp_func(lambda: (0, 0))
    try:
        ref = CmpContext(params).compress_u16(data)
    finally:
        set_timestamp_func(None)
    if frame[14:] != ref[14:] or frame[:8] != ref[:8]:  # skip identifier
        fail("SP frame != host codec")
    log("correctness gate: SP whole-frame bytes identical to host codec")
    log(f"SP whole-frame encode n=2^21: {per*1e3:.1f} ms -> {gbps:.2f} GB/s")
    RESULT["sp_encode_gbps"] = round(gbps, 3)

    chunk_bits = np.asarray(bits_dev, np.int64)
    # cross-check the device-built sidecar against the wrapper's
    chunk_bits_ref = stream_chunk_index(params, data,
                                        chunk_samples=chunk)
    ok = np.array_equal(chunk_bits, chunk_bits_ref)
    ok = ok and np.array_equal(
        np.asarray(dec_samples).astype(np.int32).astype(np.uint16),
        data)
    ok = ok and np.array_equal(np.asarray(dec_end, np.int64),
                               cfg.hdr_bits + chunk_bits)
    # the full wrapper (incl. boundary + checksum validation) must
    # also round-trip the produced frame
    wrap = decompress_long_stream(frame, chunk_bits)
    ok = ok and np.array_equal(wrap, data)
    if ok:
        g_d = 2 * n / per_d / 1e9
        log("correctness gate: sidecar decode round-trips (device + "
            "wrapper), device-built sidecar matches")
        log(f"SP sidecar decode n=2^21: {per_d*1e3:.2f} ms -> "
            f"{g_d:.2f} GB/s")
        RESULT["sp_decode_gbps"] = round(g_d, 3)
    else:
        fail("sidecar decode mismatch")

    ts = []
    for _ in range(3):
        t0 = time.time()
        compress_long_stream(mesh, params, data)
        ts.append(time.time() - t0)
    per_w = sorted(ts)[1]
    log(f"SP end-to-end (host upload + encode + fetch): "
        f"{per_w*1e3:.1f} ms -> {2 * n / per_w / 1e9:.2f} GB/s")
    RESULT["sp_wall_gbps"] = round(2 * n / per_w / 1e9, 3)


def stage_sp_chunked():
    """Streaming chunk-fed long-stream encode: the feed_many program —
    the per-chunk carry step (shard encode, funnel shift onto the carried
    bit grid, span merge) running K chunks per dispatch inside one fori
    loop.  Timed like every other device stage: the whole-stream (K=128 x
    2^14 samples) program inside a dynamic-trip-count loop, two-trip
    differenced.  A host-fed feed_many loop including chunk uploads gives
    the wall number.
    """
    from jax.sharding import Mesh

    from airs_compression_tpu.parallel.sp import (
        ChunkedLongStreamEncoder,
        _sp_feed_many_program,
        compress_long_stream,
    )

    n, chunk = 1 << 21, 1 << 14
    n_chunks = n // chunk
    params = headline_params()
    cfg = make_pass_config(params, False, True)
    rng = np.random.default_rng(4)
    data = ((1100 + rng.normal(0, 6, n)).astype(np.int64)
            & 0xFFFF).astype(np.uint16)
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    xs_dev = jnp.asarray(data.view(np.int16), jnp.int32) \
        .reshape(n_chunks, chunk)

    enc0 = ChunkedLongStreamEncoder(mesh, params, n, chunk)
    out0 = enc0._out
    hdr_bits = jnp.asarray(cfg.hdr_bits, jnp.int32)
    prog = _sp_feed_many_program(mesh, cfg, chunk, n_chunks, False)

    @jax.jit
    def loop(xs, n_iter):
        def body(i, carry):
            acc, _ = carry
            xs2 = xs ^ (acc & jnp.int32(1))
            out, cbits, prev = prog(out0, hdr_bits,
                                    jnp.asarray(0, jnp.int32),
                                    jnp.asarray(True), xs2)
            acc2 = (acc + cbits + prev
                    + jnp.sum(out, dtype=jnp.uint32).astype(jnp.int32)
                    + jnp.int32(1))
            return (acc2, cbits)

        return jax.lax.fori_loop(0, n_iter, body,
                                 (jnp.int32(0), jnp.int32(0)))
    log(f"compiling feed_many SP loop ("
        f"{n_chunks} x {chunk} samples/dispatch)...")
    t0 = time.time()
    (np.asarray(loop(xs_dev, 1)[0]))
    log(f"feed_many SP loop compiled+ran in {time.time()-t0:.1f}s")

    samples = []
    for _ in range(3):
        t_lo = time.time()
        np.asarray(loop(xs_dev, 1)[0])
        t_lo = time.time() - t_lo
        t_hi = time.time()
        np.asarray(loop(xs_dev, 33)[0])
        t_hi = time.time() - t_hi
        samples.append(max((t_hi - t_lo) / 32, 1e-9))
        log(f"  sp-chunked lo={t_lo*1e3:.1f}ms hi={t_hi*1e3:.1f}ms -> "
            f"{samples[-1]*1e3:.3f} ms/stream")
    per = sorted(samples)[1]
    sus = 2 * n / per / 1e9

    # host-fed wall: feed_many over 16-chunk buffers incl. uploads
    host_bufs = data.reshape(n_chunks // 16, 16, chunk)
    e = ChunkedLongStreamEncoder(mesh, params, n, chunk)
    t0 = time.time()
    for b in range(host_bufs.shape[0]):
        e.feed_many(host_bufs[b])
    int(np.asarray(e._carry))
    wall = 2 * n / (time.time() - t0) / 1e9

    # gate LAST (large fetches): the class-driven chunked stream (mixed
    # feed_many + feed) must equal the one-shot frame byte for byte
    if e.finish() != compress_long_stream(mesh, params, data):
        fail("chunked SP frame != one-shot frame")
    log("correctness gate: chunked SP stream byte-identical to one-shot")
    log(f"SP chunked sustained: {per*1e3:.2f} ms per 2^21-sample stream "
        f"({n_chunks} chunk steps, 1 dispatch) -> {sus:.2f} GB/s "
        f"(host-fed feed_many wall {wall:.3f} GB/s incl. uploads)")
    RESULT["sp_sustained_gbps"] = round(sus, 3)
    RESULT["sp_sustained_wall_gbps"] = round(wall, 3)
    RESULT["sp_chunk_samples"] = chunk

    # chunk-size tradeoff point: 2^17-sample chunks (16 steps) — the
    # per-step fixed cost (small pack launches) amortizes with chunk
    # size, trading producer latency for throughput toward the one-shot
    # program's rate
    chunk_l = 1 << 17
    k_l = n // chunk_l
    xs_l = xs_dev.reshape(k_l, chunk_l)
    prog_l = _sp_feed_many_program(mesh, cfg, chunk_l, k_l, False)
    enc_l = ChunkedLongStreamEncoder(mesh, params, n, chunk_l)
    out_l = enc_l._out

    @jax.jit
    def loop_l(xs, n_iter):
        def body(i, carry):
            acc, _ = carry
            xs2 = xs ^ (acc & jnp.int32(1))
            out, cbits, prev = prog_l(out_l, hdr_bits,
                                      jnp.asarray(0, jnp.int32),
                                      jnp.asarray(True), xs2)
            acc2 = (acc + cbits + prev
                    + jnp.sum(out, dtype=jnp.uint32).astype(jnp.int32)
                    + jnp.int32(1))
            return (acc2, cbits)

        return jax.lax.fori_loop(0, n_iter, body,
                                 (jnp.int32(0), jnp.int32(0)))

    (np.asarray(loop_l(xs_l, 1)[0]))
    samples = []
    for _ in range(3):
        t_lo = time.time()
        np.asarray(loop_l(xs_l, 1)[0])
        t_lo = time.time() - t_lo
        t_hi = time.time()
        np.asarray(loop_l(xs_l, 33)[0])
        t_hi = time.time() - t_hi
        samples.append(max((t_hi - t_lo) / 32, 1e-9))
    per_l = sorted(samples)[1]
    g_l = 2 * n / per_l / 1e9
    log(f"SP chunked sustained (2^17 chunks, {k_l} steps): "
        f"{per_l*1e3:.2f} ms/stream -> {g_l:.2f} GB/s")
    RESULT["sp_sustained_large_chunk_gbps"] = round(g_l, 3)


def _host_encode_raw(params_per_frame, frames_u):
    """Host-encode unique frames -> list of frame bytes."""
    from airs_compression_tpu.engine.context import CmpContext, set_timestamp_func

    raws = []
    set_timestamp_func(lambda: (0, 0))
    try:
        for p, f in zip(params_per_frame, frames_u):
            raws.append(CmpContext(p).compress_u16(f))
    finally:
        set_timestamp_func(None)
    return raws


def _host_encode_words(params_per_frame, frames_u, n_words):
    """Host-encode unique frames into a fixed-width word matrix."""
    raws = _host_encode_raw(params_per_frame, frames_u)
    need = max((len(r) + 3) // 4 for r in raws)
    n_words = max(n_words, need)
    w_np = np.zeros((len(raws), n_words), np.uint32)
    for i, raw in enumerate(raws):
        raw = raw + b"\0" * (n_words * 4 - len(raw))
        w_np[i] = np.frombuffer(raw, ">u4").astype(np.uint32)
    return w_np, n_words


def _decode_bench(tag, result_key, cfg, words, x_ref, B, N,
                  g_dyn=None, o_dyn=None, iters=1025, reps=4):
    """Shared decode-throughput stage: compile, gate round-trip, time."""
    from airs_compression_tpu.ops.decode import decode_blocks_device

    xj = jnp.asarray(x_ref)
    gd = None if g_dyn is None else jnp.asarray(g_dyn)
    od = None if o_dyn is None else jnp.asarray(o_dyn)

    @jax.jit
    def loop(w, n_iter):
        def body(i, carry):
            acc, _, _ = carry
            w2 = w ^ (acc[:, None] & jnp.uint32(1))
            s, e = decode_blocks_device(cfg, w2, xj, N, g_dyn=gd,
                                        outlier_dyn=od)
            acc2 = (jnp.sum(s.astype(jnp.uint32), axis=-1)
                    + e.astype(jnp.uint32))
            return (acc2, s, e)

        init = (jnp.zeros((B,), jnp.uint32),
                jnp.zeros((B, N), jnp.int32),
                jnp.zeros((B,), jnp.int32))
        return jax.lax.fori_loop(0, n_iter, body, init)

    log(f"compiling {tag} decode loop...")
    t0 = time.time()
    _, samples, _ = jax.tree_util.tree_map(np.asarray, loop(words, 1))
    log(f"{tag} decode loop compiled+ran in {time.time()-t0:.1f}s")
    if not np.array_equal(samples, x_ref):
        fail(f"{tag} decode round-trip mismatch")
    log(f"correctness gate: {tag} decode round-trips")

    gb = B * N * 2 / 1e9
    per_iter = measure_loop(loop, words, 1, iters, reps)
    gbps = gb / per_iter
    log(f"{tag} decode B={B} N={N}: {per_iter*1e3:.3f} ms/iter -> "
        f"{gbps:.2f} GB/s")
    RESULT[result_key] = round(gbps, 3)


def stage_decode():
    """Decode throughput + round-trip gate (lockstep decoder)."""
    from airs_compression_tpu.ops.encode import clamped_frame_words, default_cap_bits

    B, N, REP = 1024, 1024, 4
    params = headline_params()
    cfg = make_pass_config(params, False, True)
    # streams live in entropy-sized buffers (the clamped encoder's output
    # format); fall back to worst-case width if any stream doesn't fit
    n_words = clamped_frame_words(cfg, N, default_cap_bits(cfg))
    frames_u = make_frames(B // REP, N, seed=1)
    w_np, n_words = _host_encode_words([params] * (B // REP), frames_u,
                                       n_words)
    log(f"decode frame words {n_words} (worst {worst_case_words(cfg, N)})")
    frames = np.tile(frames_u, (REP, 1))
    words = jnp.asarray(np.tile(w_np, (REP, 1)))
    x_ref = frames.view(np.int16).astype(np.int32)
    _decode_bench("headline", "decode_gbps", cfg, words, x_ref, B, N,
                  iters=1025, reps=5)


def stage_decode_multi():
    """GOLOMB_MULTI decode with heavy-tailed residuals (escapes
    really taken)."""
    import dataclasses

    B, N, REP = 1024, 1024, 4
    params = dataclasses.replace(
        headline_params(), primary_encoder_type=EncoderType.GOLOMB_MULTI,
        primary_encoder_param=4, primary_encoder_outlier=30)
    cfg = make_pass_config(params, False, True)
    rng = np.random.default_rng(6)
    # heavy-tailed residuals: escapes really taken
    frames_u = ((1100 + rng.standard_t(2, (B // REP, N)) * 12)
                .astype(np.int64) & 0xFFFF).astype(np.uint16)
    w_np, n_words = _host_encode_words([params] * (B // REP), frames_u, 0)
    frames = np.tile(frames_u, (REP, 1))
    words = jnp.asarray(np.tile(w_np, (REP, 1)))
    x_ref = frames.view(np.int16).astype(np.int32)
    _decode_bench("multi", "decode_multi_gbps", cfg, words, x_ref, B, N,
                  iters=513, reps=3)


def stage_decode_b512():
    """B=512 decode (the coalesced pair of two such batches in one launch
    is measured by stage_wrapper_sustained)."""
    from airs_compression_tpu.ops.encode import clamped_frame_words, default_cap_bits

    B, N, REP = 512, 1024, 2
    params = headline_params()
    cfg = make_pass_config(params, False, True)
    n_words = clamped_frame_words(cfg, N, default_cap_bits(cfg))
    frames_u = make_frames(B // REP, N, seed=7)
    w_np, n_words = _host_encode_words([params] * (B // REP), frames_u,
                                       n_words)
    frames = np.tile(frames_u, (REP, 1))
    words = jnp.asarray(np.tile(w_np, (REP, 1)))
    x_ref = frames.view(np.int16).astype(np.int32)
    _decode_bench("b512", "decode_b512_gbps", cfg, words, x_ref, B, N,
                  iters=513, reps=3)


def stage_decode_adaptive():
    """Header-driven decode with per-lane Golomb parameters (adaptive
    streams): the dynamic-parameter decoder."""
    import dataclasses

    B, N, REP = 1024, 1024, 4
    ladder = (1, 2, 4, 8)
    base = headline_params()
    params_u = [dataclasses.replace(base, primary_encoder_param=ladder[
        i % len(ladder)]) for i in range(B // REP)]
    rng = np.random.default_rng(8)
    frames_u = np.stack([
        ((1100 + rng.normal(0, 1.5 * p.primary_encoder_param, N))
         .astype(np.int64) & 0xFFFF).astype(np.uint16)
        for p in params_u])
    w_np, n_words = _host_encode_words(params_u, frames_u, 0)
    frames = np.tile(frames_u, (REP, 1))
    words = jnp.asarray(np.tile(w_np, (REP, 1)))
    x_ref = frames.view(np.int16).astype(np.int32)
    g_np = np.array([p.primary_encoder_param for p in params_u] * REP,
                    np.uint32)
    from airs_compression_tpu.ops.encode import PassConfig

    g_cap = 1 << (int(g_np.max()) - 1).bit_length()
    cfg = PassConfig(int(Preprocessing.DIFF), int(EncoderType.GOLOMB_ZERO),
                     g_cap, 0, False, 0, False, True)
    _decode_bench("adaptive", "decode_adaptive_gbps", cfg, words, x_ref,
                  B, N, g_dyn=g_np, o_dyn=np.ones_like(g_np),
                  iters=513, reps=3)


def stage_wrapper_decode():
    """Public decode wrapper measured end-to-end: what a user of
    BatchDecompressor.decompress_frames gets, split into its host phase
    (stage_frames: C staging + one-pass C header parse/validate) and its
    device phase (group decode + batched XXH32 verify, the exact graph
    decode_staged dispatches), composed into one number.  Host->device
    transfers are excluded; the checksum IS verified in the gate and
    computed in the timed device graph.  The sustained pipelined number
    is stage_wrapper_sustained's.
    """
    import dataclasses

    from airs_compression_tpu.models.stream import BatchDecompressor, bswap32
    from airs_compression_tpu.ops.decode import decode_blocks_device
    from airs_compression_tpu.ops.xxh32_device import checksum_blocks_device

    B, N, REP = 1024, 1024, 4
    params = dataclasses.replace(headline_params(), checksum_enabled=True)
    cfg = make_pass_config(params, False, True)
    frames_u = make_frames(B // REP, N, seed=9)
    raws = _host_encode_raw([params] * (B // REP), frames_u)
    frames = list(raws) * REP
    x_ref = np.tile(frames_u, (REP, 1)).view(np.int16).astype(np.int32)

    bd = BatchDecompressor(params, B, N)
    # gate 1: the full wrapper (incl. device checksum verification)
    out = bd.decompress_frames(frames)
    if not np.array_equal(out.view(np.int16).astype(np.int32), x_ref):
        fail("wrapper decode mismatch")
    # gate 2: the pipelined generator over 4 batches (finishes deferred)
    outs = list(bd.decompress_stream(iter([frames] * 4), depth=2))
    if not all(np.array_equal(o.view(np.int16).astype(np.int32), x_ref)
               for o in outs):
        fail("decompress_stream mismatch")
    log("correctness gate: wrapper decode + pipelined stream round-trip "
        "(checksums verified on device)")

    # host phase: staging cost per call (host only, no device).  MIN of
    # several reps: the concurrent CPU scaling subprocesses contend for
    # the host's cores
    stream = b"".join(frames)
    lens = np.fromiter((len(f) for f in frames), np.int64, count=B)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    ts, ts_at = [], []
    for _ in range(9):
        t0 = time.time()
        st = bd.stage_frames(frames)
        ts.append(time.time() - t0)
        t0 = time.time()
        st = bd.stage_frames_at(stream, offs, lens)
        ts_at.append(time.time() - t0)
    t_stage = min(ts)
    t_stage_at = min(ts_at)
    RESULT["wrapper_stage_stream_ms"] = round(t_stage_at * 1e3, 3)

    # device phase: the decode_staged graph (byte swap of the raw-staged
    # words + decode + checksum) in one dynamic-trip-count loop (same
    # methodology as the kernel stages)
    words = jnp.asarray(st.words)
    xj = jnp.asarray(x_ref)

    @jax.jit
    def loop(w, n_iter):
        def body(i, carry):
            acc, _, _, _ = carry
            wr = bswap32(w) if st.raw else w
            w2 = wr ^ (acc[:, None] & jnp.uint32(1))
            s, e = decode_blocks_device(cfg, w2, xj, N)
            c = checksum_blocks_device(s)
            acc2 = (jnp.sum(s.astype(jnp.uint32), axis=-1)
                    + e.astype(jnp.uint32) + c)
            return (acc2, s, e, c)

        init = (jnp.zeros((B,), jnp.uint32), jnp.zeros((B, N), jnp.int32),
                jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.uint32))
        return jax.lax.fori_loop(0, n_iter, body, init)

    log("compiling wrapper decode loop...")
    t0 = time.time()
    _, s1, _, c1 = jax.tree_util.tree_map(np.asarray, loop(words, 1))
    log(f"wrapper decode loop compiled+ran in {time.time()-t0:.1f}s")
    if not np.array_equal(s1, x_ref):
        fail("wrapper device graph mismatch")
    if not np.array_equal(c1, np.asarray(st.stored_csum)):
        fail("device checksum != stored trailers")
    t_dev = measure_loop(loop, words, 1, 513, 3)

    gb = B * N * 2 / 1e9
    gbps = gb / (t_stage + t_dev)
    log(f"wrapper decode B={B} N={N}: stage {t_stage*1e3:.2f} ms + device "
        f"{t_dev*1e3:.2f} ms -> {gbps:.2f} GB/s")
    RESULT["wrapper_decode_gbps"] = round(gbps, 3)
    RESULT["wrapper_stage_ms"] = round(t_stage * 1e3, 3)
    RESULT["wrapper_device_ms"] = round(t_dev * 1e3, 3)


def stage_wrapper_sustained():
    """Sustained pipelined wrapper decode.

    The decompress_stream steady state: per batch, host staging from the
    contiguous stream (stage_frames_at) followed by ONE fused device
    dispatch (byte swap + lockstep decode + device checksum,
    models/stream._decode_group_fused).  Also measures the grouped and
    device-staged launches and the coalesced B=512 pair
    (decode_staged_multi).  Round-trip + checksum gates run after the
    timed loops.
    """
    import dataclasses

    from airs_compression_tpu.models.stream import BatchDecompressor

    B, N, REP = 1024, 1024, 4
    params = dataclasses.replace(headline_params(), checksum_enabled=True)
    frames_u = make_frames(B // REP, N, seed=9)
    raws = _host_encode_raw([params] * (B // REP), frames_u)
    frames = list(raws) * REP
    x_ref = np.tile(frames_u, (REP, 1)).view(np.int16).astype(np.int32)

    bd = BatchDecompressor(params, B, N)
    stream = b"".join(frames)
    lens = np.fromiter((len(f) for f in frames), np.int64, count=B)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    st0 = bd.stage_frames_at(stream, offs, lens)
    words_pool = jnp.asarray(st0.words)

    def pipeline(m):
        # one-deep pipeline with a sync per batch, like the real
        # decompress_stream driver (finish() syncs once the pipeline
        # fills): batch k+1's staging overlaps batch k's decode, and
        # outstanding dispatches stay bounded.
        prev = dec = None
        for _ in range(m):
            st_k = bd.stage_frames_at(stream, offs, lens)
            dec = bd.decode_staged(st_k, words_dev=words_pool)
            if prev is not None:
                prev.block_until_ready()
            prev = dec.end_bits
        prev.block_until_ready()
        return prev, dec
    log("compiling sustained wrapper decode...")
    t0 = time.time()
    _, dec_last = pipeline(2)
    log(f"sustained wrapper decode compiled+ran in {time.time()-t0:.1f}s")
    samples = []
    for _ in range(5):
        t_lo = time.time()
        pipeline(4)
        t_lo = time.time() - t_lo
        t_hi = time.time()
        pipeline(36)
        t_hi = time.time() - t_hi
        samples.append(max((t_hi - t_lo) / 32, 1e-9))
        log(f"  sustained lo={t_lo*1e3:.1f}ms hi={t_hi*1e3:.1f}ms -> "
            f"{samples[-1]*1e3:.3f} ms/batch")
    # MIN of reps: the loop interleaves real host staging with
    # dispatches, so host noise only ever inflates a sample
    per_b = min(samples)
    gb = B * N * 2 / 1e9

    # grouped steady state — decompress_stream's DEFAULT for stateless
    # streams: GROUP consecutive batches staged on host, then ONE fused
    # dispatch (_stack_decode_group_fused: swap + pad + stack + gridded
    # 4096-lane decode + checksum) per group, amortizing per-launch
    # latency GROUP-ways.  This is the wrapper's real per-batch rate.
    group = bd._coalesce_group(None)
    per_b_grouped = None
    if group > 1:
        def pipeline_grouped(m):
            # same sync discipline per GROUP: one launch, one deferred
            # sync — group k+1's four stagings overlap group k's decode.
            # same sync discipline as pipeline()
            prev = None
            for _ in range(m):
                sts = [bd.stage_frames_at(stream, offs, lens)
                       for _ in range(group)]
                dec = bd.decode_staged_multi(
                    sts, words_dev=[words_pool] * group)[-1]
                if prev is not None:
                    prev.block_until_ready()
                prev = dec.end_bits
            prev.block_until_ready()
            return prev
        log(f"compiling grouped sustained decode (group={group})...")
        t0 = time.time()
        pipeline_grouped(1)
        log(f"grouped sustained decode compiled+ran in {time.time()-t0:.1f}s")
        gsamples = []
        for _ in range(5):
            t_lo = time.time()
            pipeline_grouped(1)
            t_lo = time.time() - t_lo
            t_hi = time.time()
            pipeline_grouped(9)
            t_hi = time.time() - t_hi
            gsamples.append(max((t_hi - t_lo) / (8 * group), 1e-9))
            log(f"  grouped lo={t_lo*1e3:.1f}ms hi={t_hi*1e3:.1f}ms -> "
                f"{gsamples[-1]*1e3:.3f} ms/batch")
        per_b_grouped = min(gsamples)

    # device-staged sustained (decompress_file_stream's steady state):
    # the compressed stream lives ON DEVICE (uploaded once); per batch
    # the host parses ~30 header bytes/frame (native stage_parse_at, no
    # payload scatter) and a grouped fused dispatch gathers/aligns the
    # rows on device before decoding.  Fetch-free, same sync discipline.
    ds = bd.upload_stream(stream)
    dg = max(1, group)
    off_gdev = jnp.asarray(
        np.concatenate([offs] * dg).astype(np.int32))
    len_gdev = jnp.asarray(
        np.concatenate([lens] * dg).astype(np.int32))

    def pipeline_devstaged(m):
        prev = None
        for _ in range(m):
            sts = [bd.stage_headers_at(stream, offs, lens)
                   for _ in range(dg)]
            dec = bd.decode_staged_from_multi(
                sts, ds, offsets_dev=off_gdev, lens_dev=len_gdev)[-1]
            if prev is not None:
                prev.block_until_ready()
            prev = dec.end_bits
        prev.block_until_ready()
        return prev
    log(f"compiling device-staged sustained decode (group={dg})...")
    t0 = time.time()
    pipeline_devstaged(1)
    log(f"device-staged sustained compiled+ran in {time.time()-t0:.1f}s")
    dsamples = []
    for _ in range(5):
        t_lo = time.time()
        pipeline_devstaged(1)
        t_lo = time.time() - t_lo
        t_hi = time.time()
        pipeline_devstaged(9)
        t_hi = time.time() - t_hi
        dsamples.append(max((t_hi - t_lo) / (8 * dg), 1e-9))
        log(f"  dev-staged lo={t_lo*1e3:.1f}ms hi={t_hi*1e3:.1f}ms -> "
            f"{dsamples[-1]*1e3:.3f} ms/batch")
    per_b_devstaged = min(dsamples)

    # coalesced B=512 pair: one launch decodes two sub-tile batches.
    # The launch's device graph (stack = swap/pad/concat, then the fused
    # decode + checksum) is timed with the standard dynamic-trip-count
    # differencing — the same methodology as every kernel stage.
    from airs_compression_tpu.models.stream import (
        _decode_group_fused,
        _stack_words,
    )

    cfg = make_pass_config(params, False, True)
    B2 = B // 2
    bd2 = BatchDecompressor(params, B2, N)
    half = len(frames) // 2
    st1 = bd2.stage_frames(frames[:half])
    st2 = bd2.stage_frames(frames[half:])
    w1 = jnp.asarray(st1.words)
    w2 = jnp.asarray(st2.words)
    raws = (st1.raw, st2.raw)
    nw = max(st1.n_words, st2.n_words)
    zmodel = jnp.zeros((B, N), jnp.int32)

    @jax.jit
    def coal_loop(w_pair, n_iter):
        wa, wb = w_pair

        def body(i, carry):
            acc = carry[0]
            stacked = _stack_words([wa ^ (acc & jnp.uint32(1)),
                                    wb ^ (acc & jnp.uint32(1))],
                                   raws, nw)
            s, e, c = _decode_group_fused(cfg, stacked, zmodel, N,
                                          False, True)
            acc2 = (jnp.sum(s.astype(jnp.uint32))
                    + jnp.sum(e.astype(jnp.uint32)) + jnp.sum(c)
                    + jnp.uint32(1))
            return (acc2, e)

        return jax.lax.fori_loop(
            0, n_iter, body,
            (jnp.uint32(0), jnp.zeros((B,), jnp.int32)))

    np.asarray(coal_loop((w1, w2), 1)[0])
    per_launch = measure_loop(coal_loop, (w1, w2), 1, 513, 3)

    # gates LAST: full round-trip incl. checksum verification
    out = bd.finish(bd.stage_frames_at(stream, offs, lens),
                    bd.decode_staged(
                        bd.stage_frames_at(stream, offs, lens),
                        words_dev=words_pool))
    if not np.array_equal(out.view(np.int16).astype(np.int32), x_ref):
        fail("sustained wrapper decode mismatch")
    decs = bd2.decode_staged_multi([st1, st2], words_dev=[w1, w2])
    for st_i, dec_i, lo in ((st1, decs[0], 0), (st2, decs[1], half)):
        got = bd2.finish(st_i, dec_i)
        if not np.array_equal(got.view(np.int16).astype(np.int32),
                              x_ref[lo:lo + B2]):
            fail("coalesced pair mismatch")
    if per_b_grouped is not None:
        # gate: the grouped launch (stack fused into the decode program)
        # round-trips with checksums against the same reference
        sts_g = [bd.stage_frames_at(stream, offs, lens)
                 for _ in range(group)]
        decs_g = bd.decode_staged_multi(sts_g,
                                        words_dev=[words_pool] * group)
        for st_i, dec_i in zip(sts_g, decs_g):
            got = bd.finish(st_i, dec_i)
            if not np.array_equal(got.view(np.int16).astype(np.int32),
                                  x_ref):
                fail("grouped sustained decode mismatch")
    # gate: device-staged grouped decode round-trips with checksums
    ds_g = bd.upload_stream(stream)
    sts_d = [bd.stage_headers_at(stream, offs, lens)
             for _ in range(max(1, group))]
    decs_d = bd.decode_staged_from_multi(sts_d, ds_g)
    for st_i, dec_i in zip(sts_d, decs_d):
        got = bd.finish(st_i, dec_i)
        if not np.array_equal(got.view(np.int16).astype(np.int32),
                              x_ref):
            fail("device-staged sustained decode mismatch")
    log("correctness gate: sustained + coalesced wrapper decode "
        "round-trip (checksums verified on device)")
    sus_solo = gb / per_b
    log(f"wrapper decode sustained (per-batch dispatch): "
        f"{per_b*1e3:.3f} ms/batch -> {sus_solo:.2f} GB/s")
    RESULT["wrapper_decode_sustained_solo_gbps"] = round(sus_solo, 3)
    best, best_how = per_b, "per-batch"
    if per_b_grouped is not None:
        sus = gb / per_b_grouped
        log(f"wrapper decode sustained (grouped x{group}): "
            f"{per_b_grouped*1e3:.3f} ms/batch -> {sus:.2f} GB/s")
        RESULT["wrapper_decode_grouped_gbps"] = round(sus, 3)
        RESULT["wrapper_decode_sustained_group"] = group
        if per_b_grouped < best:
            best, best_how = per_b_grouped, f"grouped x{group}"
    sus = gb / per_b_devstaged
    log(f"wrapper decode sustained (device-staged file stream, "
        f"grouped x{max(1, group)}): {per_b_devstaged*1e3:.3f} "
        f"ms/batch -> {sus:.2f} GB/s")
    RESULT["wrapper_decode_devstaged_gbps"] = round(sus, 3)
    if per_b_devstaged < best:
        best, best_how = per_b_devstaged, "device-staged grouped"
    RESULT["wrapper_decode_sustained_gbps"] = round(gb / best, 3)
    RESULT["wrapper_decode_sustained_how"] = best_how
    log(f"wrapper decode sustained (best public path: {best_how}): "
        f"{gb/best:.2f} GB/s")
    g_c = gb / per_launch
    log(f"b512 coalesced decode: {per_launch*1e3:.3f} ms per 2-batch "
        f"launch -> {g_c:.2f} GB/s per byte")
    RESULT["decode_b512_coalesced_gbps"] = round(g_c, 3)


def stage_wrapper_encode():
    """Public ENCODE wrapper end-to-end: what
    BatchCompressor.compress_frames_packed delivers.  Host-assemble path:
    device phase = encode graph + on-device byteswap; host phase = the
    native C row gather + chain bookkeeping.  Device-assemble path
    (stream merged on device via the funnel-shift tree): one device
    program.  The device->host fetch is excluded (same rule as the decode
    wrapper); the byte-identity gate runs against the host codec.
    """
    from airs_compression_tpu import native
    from airs_compression_tpu.engine.context import (
        CmpContext,
        set_timestamp_func,
    )
    from airs_compression_tpu.models.stream import (
        BatchCompressor,
        _pack_stream_device,
        bswap32,
    )
    from airs_compression_tpu.ops.encode import (
        clamped_frame_words,
        default_cap_bits,
    )

    B, N = 512, 8192
    params = headline_params()
    cfg = make_pass_config(params, False, True)
    frames = make_frames(B, N, seed=11)

    # gate: packed wrapper output byte-identical to the host codec
    set_timestamp_func(lambda: (0, 0))
    try:
        bc = BatchCompressor(params, B, N)
        stream, sizes = bc.compress_frames_packed(frames)
        offs = np.concatenate(([0], np.cumsum(sizes)[:-1]))
        for i in range(4):
            ref = CmpContext(params).compress_u16(frames[i])
            if bytes(stream[offs[i]: offs[i] + sizes[i]]) != ref:
                fail("packed wrapper != host codec")
        # the default path must match the host gather over the FULL
        # stream, every word-boundary case included
        stream_h, sizes_h = BatchCompressor(
            params, B, N).compress_frames_packed(frames, False, "host")
        if stream_h != stream or not np.array_equal(sizes, sizes_h):
            fail("default assembly != host gather")
    finally:
        set_timestamp_func(None)
    log("correctness gate: packed encode wrapper byte-identical to host "
        "codec; default assembly == host gather over the full stream")

    # device phase A (host-assemble path): encode graph + byteswap,
    # one dynamic-trip loop (same methodology as the headline stage)
    cap = RESULT.get("pack_cap_bits", default_cap_bits(cfg))
    n_words = clamped_frame_words(cfg, N, cap)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    seq = jnp.zeros((B,), jnp.int32)
    ids = jnp.zeros((B,), jnp.uint32)
    csum = jnp.zeros((B,), jnp.uint32)

    def make_loop(mode):
        @jax.jit
        def loop(x, n_iter):
            def body(i, carry):
                acc = carry[0]
                x2 = x ^ (acc[:, None] & jnp.int32(1))
                if cap is not None:
                    words, szs, ok = _encode_one_pass(
                        cfg, x2, x2, seq, ids, ids, csum, n_words,
                        cap_bits=cap)
                else:
                    words, szs = _encode_one_pass(cfg, x2, x2, seq, ids,
                                                  ids, csum, n_words)
                    ok = jnp.ones((B,), bool)
                if mode == "device":
                    out = _pack_stream_device(words, szs, True)
                else:
                    out = bswap32(words)
                acc2 = (jnp.sum(out, dtype=jnp.uint32)
                        .astype(jnp.int32) + szs + ok.astype(jnp.int32))
                return (acc2, out, szs, ok)

            shape = (B * n_words,) if mode == "device" else (B, n_words)
            init = (jnp.zeros((B,), jnp.int32),
                    jnp.zeros(shape, jnp.uint32),
                    jnp.zeros((B,), jnp.int32),
                    jnp.ones((B,), bool))
            return jax.lax.fori_loop(0, n_iter, body, init)

        return loop

    loop = make_loop("host")
    log("compiling wrapper encode loop...")
    t0 = time.time()
    _, words_np, sizes_np, ok_np = jax.tree_util.tree_map(np.asarray, loop(x, 1))
    log(f"wrapper encode loop compiled+ran in {time.time()-t0:.1f}s")
    if not ok_np.all():
        log("wrapper encode: clamp overflowed; skipping timed point")
        return
    t_dev = measure_loop(loop, x, 1, 513, 3)

    # host phase A on the fetched swapped rows: C row gather (packed
    # stream extraction) + the bulk identifier draw; MIN of reps
    # (host-core contention, same rule as the decode wrapper)
    rows = np.ascontiguousarray(words_np).view(np.uint8) \
        .reshape(B, n_words * 4)
    bc2 = BatchCompressor(params, B, N)
    ts = []
    for _ in range(9):
        t0 = time.time()
        if native.native_available():
            native.gather_rows(rows, sizes_np, n_words * 4)
        else:
            b"".join(rows[b, : sizes_np[b]].tobytes() for b in range(B))
        bc2._draw_ids(np.ones(B, dtype=bool))
        ts.append(time.time() - t0)
    t_host = min(ts)

    gb = B * N * 2 / 1e9
    gbps = gb / (t_dev + t_host)
    log(f"wrapper encode B={B} N={N} (host-assemble): device "
        f"{t_dev*1e3:.3f} ms + host {t_host*1e3:.3f} ms -> {gbps:.2f} "
        f"GB/s (pipelined ceiling {gb / max(t_dev, t_host):.2f} GB/s)")
    RESULT["wrapper_encode_gbps"] = round(gbps, 3)
    RESULT["wrapper_encode_hostasm_gbps"] = round(gbps, 3)
    RESULT["wrapper_encode_host_ms"] = round(t_host * 1e3, 3)
    RESULT["wrapper_encode_device_ms"] = round(t_dev * 1e3, 3)

    # device-assemble variant: the merge tree's device cost replaces the
    # host gather
    loop_d = make_loop("device")
    np.asarray(loop_d(x, 1)[0])
    t_dev_d = measure_loop(loop_d, x, 1, 257, 3)
    g_d = gb / t_dev_d
    log(f"wrapper encode (device-assemble variant): "
        f"{t_dev_d*1e3:.3f} ms/iter -> {g_d:.2f} GB/s")
    RESULT["wrapper_encode_devassemble_gbps"] = round(g_d, 3)


def stage_adaptive_encode():
    """Adaptive-tier ENCODE throughput: per-block Golomb parameter
    selection over the default ladder, fused with the encode."""
    from airs_compression_tpu.engine.host import decode_block
    from airs_compression_tpu.ops.adapt import DEFAULT_LADDER
    from airs_compression_tpu.ops.encode import (
        adaptive_cap_bits,
        adaptive_worst_case_words,
        encode_blocks_adaptive,
    )

    B, N = 512, 8192
    params = headline_params()
    cfg = make_pass_config(params, False, True)
    ladder = DEFAULT_LADDER
    n_words = adaptive_worst_case_words(cfg, N, ladder)
    cap = adaptive_cap_bits(cfg, ladder)
    rng = np.random.default_rng(10)
    # widening noise across the batch so the ladder really varies
    sig = np.empty((B, N), np.uint16)
    for i in range(B):
        sig[i] = (1100 + rng.normal(0, 0.7 * (1 + i % 12), N)).astype(
            np.int64) & 0xFFFF
    x = jnp.asarray(sig.view(np.int16), jnp.int32)
    seq = jnp.zeros((B,), jnp.int32)
    ids = jnp.zeros((B,), jnp.uint32)
    csum = jnp.zeros((B,), jnp.uint32)

    @jax.jit
    def loop(x, n_iter):
        def body(i, carry):
            acc = carry[0]
            x2 = x ^ (acc[:, None] & jnp.int32(1))
            w, s, fb, g, ok = encode_blocks_adaptive(
                cfg, None, x2, x2, seq, ids, ids, csum, n_words, ladder,
                cap_bits=cap)
            g = g.astype(jnp.int32)
            acc2 = (jnp.sum(w, axis=-1, dtype=jnp.uint32)
                    .astype(jnp.int32) + s + g + ok.astype(jnp.int32))
            return (acc2, w, s, g, ok)

        init = (jnp.zeros((B,), jnp.int32),
                jnp.zeros((B, n_words), jnp.uint32),
                jnp.zeros((B,), jnp.int32),
                jnp.zeros((B,), jnp.int32),
                jnp.ones((B,), bool))
        return jax.lax.fori_loop(0, n_iter, body, init)

    log("compiling adaptive encode loop...")
    t0 = time.time()
    _, words, sizes, gs, pack_ok = jax.tree_util.tree_map(np.asarray, loop(x, 1))
    log(f"adaptive encode loop compiled+ran in {time.time()-t0:.1f}s "
        f"(distinct g: {sorted(set(gs.tolist()))})")
    if not pack_ok.all():
        log("adaptive: entropy clamp overflowed; skipping timed point")
        return

    # gate: frames decode back to the source via the host oracle
    for i in (0, B // 2, B - 1):
        blob = words[i].astype(">u4").tobytes()[: int(sizes[i])]
        dec, hdr, _ = decode_block(blob)
        if not np.array_equal(dec, sig[i]):
            fail("adaptive frame does not round-trip")
        if hdr.encoder_param != int(gs[i]):
            fail("header g != selected g")
    log("correctness gate: adaptive frames host-decode to source, "
        "headers carry the selected parameter")

    gb = B * N * 2 / 1e9
    per_iter = measure_loop(loop, x, 1, 513, 3)
    gbps = gb / per_iter
    log(f"adaptive encode B={B} N={N}: {per_iter*1e3:.3f} ms/iter -> "
        f"{gbps:.2f} GB/s")
    RESULT["adaptive_encode_gbps"] = round(gbps, 3)


def _cpu_env(n_virtual: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_virtual}")
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + pp)
    return env


def launch_cpu_stages():
    """Start the CPU-only scaling stages as subprocesses (run concurrently
    with the GPU stages; ``_cpu_env`` pins them to the CPU, so they never
    open the card).

    * dp weak-scaling curve on an 8-virtual-device mesh
      (tools/dp_scaling.py, correctness asserted at every point);
    * the 2-process jax.distributed splice pipeline
      (tests/multihost_worker.py: encode -> allgather sizes -> manifest ->
      splice -> byte parity -> decode), timed end-to-end.
    """
    import socket
    import subprocess
    import tempfile

    handles = {}
    try:
        handles["dp_scaling"] = (
            subprocess.Popen(
                [sys.executable, str(REPO / "tools" / "dp_scaling.py")],
                env=_cpu_env(8), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True),
            time.time())
    except OSError as e:
        log(f"dp_scaling launch failed: {e}")
    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        tmpd = tempfile.mkdtemp(prefix="airs_mh_")
        worker = str(REPO / "tests" / "multihost_worker.py")
        procs = [subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), tmpd],
            env=_cpu_env(2), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for pid in range(2)]
        handles["multihost"] = (procs, tmpd, time.time())
    except OSError as e:
        log(f"multihost launch failed: {e}")
    return handles


def collect_cpu_stages(handles):
    import json as _json
    import pathlib

    if "dp_scaling" in handles:
        proc, t0 = handles["dp_scaling"]
        try:
            out, err = proc.communicate(timeout=max(30, min(remaining(),
                                                            900)))
            last = [ln for ln in out.strip().splitlines()
                    if ln.startswith("{")]
            if proc.returncode == 0 and last:
                parsed = _json.loads(last[-1])
                RESULT["dp_scaling"] = {
                    "backend": parsed.get("backend"),
                    "host_cores": parsed.get("host_cores"),
                    "rows": parsed["rows"],
                    # fixed total work sharded wider: flat-ideal even on
                    # shared cores, so growth = sharded-path overhead
                    "fixed_total_rows": parsed.get("fixed_total_rows"),
                    # mechanistic decomposition: collective counts,
                    # dispatch floors, contention-vs-structure analysis
                    "analysis": parsed.get("analysis")}
                log(f"dp_scaling: {len(parsed['rows'])} mesh points, "
                    f"eff@8 = "
                    f"{parsed['rows'][-1].get('weak_efficiency_pct')}%")
            else:
                log(f"dp_scaling failed rc={proc.returncode}: "
                    f"{err.strip().splitlines()[-3:]}")
        except Exception as e:
            proc.kill()
            log(f"dp_scaling collect failed: {type(e).__name__} {e}")
    if "multihost" in handles:
        procs, tmpd, t0 = handles["multihost"]
        try:
            deadline = max(30, min(remaining(), 600))
            for p in procs:
                p.communicate(timeout=deadline)
            wall = time.time() - t0
            ok = (pathlib.Path(tmpd) / "OK").exists() and all(
                p.returncode == 0 for p in procs)
            RESULT["multihost_2proc"] = {
                "ok": bool(ok), "wall_s": round(wall, 1)}
            log(f"multihost 2-proc splice: ok={ok} wall={wall:.1f}s")
        except Exception as e:
            for p in procs:
                p.kill()
            log(f"multihost collect failed: {type(e).__name__} {e}")


def stage_verify_configs():
    """On-hardware byte-exactness sweep: chip_smoke.py's encode and decode
    phases at a reduced size (the full sizes run in chip_smoke.py)."""
    import chip_smoke

    B, N = 128, 512
    chip_smoke.set_timestamp_func(lambda: (0, 0))
    try:
        frames = chip_smoke.phase_frames(B=B, N=N, batches=1)
        chains = chip_smoke.phase_chains(B=B, N=N)
        adaptive = chip_smoke.phase_adaptive(B=B, N=N, batches=1)
        chip_smoke.phase_decode(frames, chains, adaptive, B=B, N=N,
                                B2=B, N2=N)
    finally:
        chip_smoke.set_timestamp_func(None)
    RESULT["hw_verified_configs"] = 4


def main():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"bench: no GPU found (platform {devs[0].platform}); refusing "
            "to measure")
        sys.exit(2)
    RESULT.update(platform=devs[0].platform,
                  device_kind=devs[0].device_kind, device_count=len(devs))
    cpu_handles = launch_cpu_stages()  # runs concurrently on host cores
    log(f"devices: {devs}  (deadline {DEADLINE_S:.0f}s, cache {_CACHE})")

    stage_encode()
    # further stages, priority order; a failing stage fails the run
    optional = [
        (stage_encode_csum, 420),
        (stage_decode, 300),
        (stage_verify_configs, 360),
        (stage_decode_multi, 420),
        (stage_flagship, 420),
        (stage_adaptive_encode, 420),
        (stage_decode_adaptive, 420),
        (stage_decode_b512, 420),
        (stage_sp, 420),
        (stage_sp_chunked, 420),
        (stage_wrapper_sustained, 420),
        (stage_wrapper_encode, 420),
        (stage_wrapper_decode, 420),
    ]
    for stage, min_budget in optional:
        if remaining() <= min_budget:
            log(f"skipping {stage.__name__}: deadline near "
                f"({remaining():.0f}s left)")
            continue
        stage()

    collect_cpu_stages(cpu_handles)
    print(json.dumps(RESULT), flush=True)


if __name__ == "__main__":
    main()
