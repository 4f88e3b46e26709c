"""Measured data-parallel scaling curve over a device mesh.

Weak scaling: each device encodes a fixed per-device batch (B0 blocks of
N samples), so the global batch grows with the mesh; ideal scaling keeps
the time flat and efficiency = T(1) / T(d).  Correctness is asserted at
every point (sharded rows must equal the single-device encode).

On the CPU backend with --xla_force_host_platform_device_count=8 the
"devices" share the host's physical cores, so the curve measures the
sharded path's overhead and correctness rather than hardware speedup —
the real curve needs several GPUs (same code, bigger mesh).  Run:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/dp_scaling.py

Prints one row per mesh size and a final JSON summary line.
"""

import json
import os
import pathlib
import sys
import time

_REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO))

import numpy as np

import jax

from airs_compression_tpu.format.params import CmpParams, EncoderType, Preprocessing
from airs_compression_tpu.ops.encode import (
    encode_blocks_device, make_pass_config, worst_case_words)
from airs_compression_tpu.parallel.dp import place_encode_operands
from airs_compression_tpu.parallel.mesh import make_mesh


def collective_count(mesh, cfg, n_words, B, N, frames_i32) -> "dict":
    """Mechanistic evidence for the scaling claim: what the compiled
    sharded program actually contains.

    DP over blocks is embarrassingly parallel — the compiled module must
    contain ZERO cross-device collectives, so the only cost sharding can
    add is per-dispatch/partitioning overhead, never communication.
    Counted from the compiled HLO text (the artifact records the count
    instead of asserting, so a regression is visible in the bench JSON).
    """
    zb = np.zeros((B,), np.int32)
    zu = np.zeros((B,), np.uint32)
    args = place_encode_operands(mesh, frames_i32, frames_i32, zb, zu, zu, zu)
    txt = encode_blocks_device.lower(cfg, None, *args, n_words) \
        .compile().as_text()
    names = ("all-reduce", "all-gather", "collective-permute",
             "reduce-scatter", "all-to-all")
    return {n: txt.count(n) for n in names if txt.count(n)} or {}


def dispatch_floor(mesh, cfg, B, N=128, reps=15) -> float:
    """Per-call floor of the sharded program at near-zero work (B = one
    block per device, tiny N): isolates dispatch + partition overhead
    from compute.  Median seconds."""
    n_words = worst_case_words(cfg, N)
    x = np.zeros((B, N), np.int32)
    zb = np.zeros((B,), np.int32)
    zu = np.zeros((B,), np.uint32)
    args = place_encode_operands(mesh, x, x, zb, zu, zu, zu)

    def run():
        w, s, _ = encode_blocks_device(cfg, None, *args, n_words)
        jax.block_until_ready((w, s))

    run()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def measure(mesh, cfg, n_words, B, N, frames_i32, reps=9):
    """Median wall time of the sharded encode over ``mesh``.

    Operands are placed once (device-resident, the steady-state pipeline
    pattern — parallel/dp.place_encode_operands); the timed region is
    the sharded encode program only.  Per-call ``device_put`` placement
    used to dominate the curve and read as a fake scaling cliff.
    """
    zb = np.zeros((B,), np.int32)
    zu = np.zeros((B,), np.uint32)
    args = place_encode_operands(mesh, frames_i32, frames_i32,
                                 zb, zu, zu, zu)

    def run():
        w, s, _ = encode_blocks_device(cfg, None, *args, n_words)
        jax.block_until_ready((w, s))
        return w, s

    words, sizes = run()  # compile + correctness handle
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], np.asarray(words), np.asarray(sizes)


def main():
    B0 = int(os.environ.get("AIRS_SCALE_B0", "64"))
    N = int(os.environ.get("AIRS_SCALE_N", "2048"))
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4)
    cfg = make_pass_config(params, False, True)
    n_words = worst_case_words(cfg, N)

    n_dev = jax.device_count()
    sizes_to_try = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    print(f"backend={jax.default_backend()} devices={n_dev} "
          f"B0={B0} N={N}", file=sys.stderr)

    rng = np.random.default_rng(0)
    rows = []
    for d in sizes_to_try:
        B = B0 * d
        frames = ((1100 + rng.normal(0, 6, (B, N))).astype(np.int64)
                  & 0xFFFF).astype(np.uint16)
        x = frames.view(np.int16).astype(np.int32)
        mesh = make_mesh(d)
        t, words, szs = measure(mesh, cfg, n_words, B, N, x)

        # correctness: rows must equal the single-device encode of the
        # same blocks (first B0 rows against a 1-device mesh run)
        if d > 1:
            m1 = make_mesh(1)
            _, w1, s1 = measure(m1, cfg, n_words, B0, N,
                                x[:B0], reps=1)
            assert np.array_equal(words[:B0], w1) and \
                np.array_equal(szs[:B0], s1), f"sharded mismatch at d={d}"

        gbps = B * N * 2 / t / 1e9
        rows.append({"devices": d, "blocks": B, "ms": round(t * 1e3, 2),
                     "gbps": round(gbps, 3)})
        print(f"d={d:2d}  B={B:4d}  {t*1e3:8.2f} ms  {gbps:7.3f} GB/s",
              file=sys.stderr)

    t1 = rows[0]["ms"]
    for r in rows:
        r["weak_efficiency_pct"] = round(100.0 * t1 / r["ms"], 1)

    # fixed-TOTAL-work curve: same global batch sharded over more
    # devices.  On shared host cores the weak curve must grow (total
    # compute grows, cores don't), but this one is flat-ideal — its
    # growth isolates the sharded path's own overhead, which is the
    # quantity the >= 90% multi-host target needs to be ~zero.
    B_tot = B0 * sizes_to_try[-1]
    frames = ((1100 + rng.normal(0, 6, (B_tot, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    x_tot = frames.view(np.int16).astype(np.int32)
    rows_fixed = []
    for d in sizes_to_try:
        mesh = make_mesh(d)
        t, _, _ = measure(mesh, cfg, n_words, B_tot, N, x_tot)
        colls = collective_count(mesh, cfg, n_words, B_tot, N, x_tot)
        floor = dispatch_floor(mesh, cfg, B=d)
        rows_fixed.append({"devices": d, "blocks": B_tot,
                           "ms": round(t * 1e3, 2),
                           "collectives": colls,
                           "dispatch_floor_ms": round(floor * 1e3, 3)})
        print(f"fixed-total d={d:2d}  B={B_tot:4d}  {t*1e3:8.2f} ms  "
              f"collectives={colls or 0}  floor={floor*1e3:.2f} ms",
              file=sys.stderr)
    tf = rows_fixed[0]["ms"]
    for r in rows_fixed:
        r["overhead_pct"] = round(100.0 * (r["ms"] - tf) / tf, 1)

    # Decomposition: on shared host cores the
    # weak curve confounds core oversubscription with sharded-program
    # overhead.  Separate the two mechanistically:
    #  * the compiled sharded module contains NO collectives (counted
    #    above) — block-DP cannot add communication, only per-dispatch
    #    and partitioning cost;
    #  * that cost is measured directly as the near-zero-work dispatch
    #    floor per mesh size;
    #  * the fixed-total curve's growth past the core-saturated point
    #    (the widest mesh <= physical cores) is the remaining structural
    #    overhead at real work sizes.
    cores = os.cpu_count() or 1
    saturated = [r for r in rows_fixed if r["devices"] <= cores]
    base = (saturated[-1] if saturated else rows_fixed[0])
    over = [r for r in rows_fixed if r["devices"] > base["devices"]]
    struct_pct = (max(100.0 * (r["ms"] - base["ms"]) / base["ms"]
                      for r in over) if over else 0.0)
    analysis = {
        "collective_free": all(not r["collectives"] for r in rows_fixed),
        "baseline_devices": base["devices"],
        "structural_overhead_pct": round(struct_pct, 1),
        "max_dispatch_floor_ms": max(r["dispatch_floor_ms"]
                                     for r in rows_fixed),
        "note": (
            "sharded program adds structural_overhead_pct over the "
            f"core-saturated {base['devices']}-device mesh at equal total "
            "work on this box; the remaining (100 - weak_efficiency) is "
            f"host-core contention ({cores} physical cores shared by up "
            f"to {sizes_to_try[-1]} virtual devices).  Zero collectives "
            "in the compiled module means sharding adds dispatch/"
            "partition cost only — the quantity bounded by "
            "dispatch_floor_ms — not communication."),
    }
    print(json.dumps({"metric": "dp_weak_scaling",
                      "backend": jax.default_backend(),
                      # virtual devices beyond the physical core count
                      # share cores: the weak curve then measures core
                      # oversubscription; the fixed-total curve isolates
                      # sharded-path overhead
                      "host_cores": os.cpu_count(),
                      "rows": rows,
                      "fixed_total_rows": rows_fixed,
                      "analysis": analysis}))


if __name__ == "__main__":
    main()
