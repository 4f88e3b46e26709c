"""Batched on-device XXH32 — the AIRSPACE block checksum, lane-parallel.

The reference computes XXH32 inline while encoding each block
(lib/compress/cmp.c:314-319, lib/common/header.c:137-163, seed 419764627
over the samples as big-endian u16 bytes).  The host wrapper used to do
the same sequentially per block in the middle of the device pipeline;
per-block checksums are independent, so here B blocks hash at once:

* XXH32's only cross-word dependency is its 4-lane accumulator recurrence
  ``acc = rotl13(acc + w * P2) * P1`` over 16-byte stripes — strictly
  sequential along the stripe axis but elementwise across (block, lane),
  i.e. a (B, 4)-wide chain of N/8 cheap elementwise steps.
* :func:`xxh32_blocks` runs that chain as a ``lax.scan`` (any backend);
  on a GPU each stripe step costs at least one kernel launch.
* :func:`xxh32_blocks_triton` runs it as one GPU kernel (Pallas, Triton
  route): one thread per block, the stripe loop inside the kernel and
  the 4 accumulators in registers; each stripe loads the block's 8
  samples (one 32-byte sector) straight from the (B, N) sample array.

Both are bit-exact against utils/xxh32 (itself pinned to the vendored
xxhash 0.8.3 the reference uses, subprojects/xxhash.wrap:1-14).

Byte order note: the AIRSPACE convention hashes *big-endian* sample
bytes, while XXH32 consumes its stripe words *little-endian* — so each
u32 lane word is ``bswap16(s[2j]) | bswap16(s[2j+1]) << 16``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.xxh32 import CHECKSUM_SEED

__all__ = ["xxh32_blocks", "xxh32_blocks_triton", "triton_xxh32_supported",
           "checksum_blocks_device", "use_device_checksum"]

_U32 = jnp.uint32
_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393

LANES = 32    # blocks per program: one warp, one lane per block
_UNROLL = 8   # stripes per loop iteration (loads issued ahead of the chain)


def _rotl(x, r: int):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _lane_words(x: jax.Array) -> jax.Array:
    """(B, N) u16-valued samples -> (B, N//2) LE stripe words of BE bytes."""
    s = x.astype(_U32) & _U32(0xFFFF)
    sw = ((s & _U32(0xFF)) << _U32(8)) | (s >> _U32(8))  # bswap16
    return sw[:, 0::2] | (sw[:, 1::2] << _U32(16))


def _finalize(h: jax.Array) -> jax.Array:
    h = (h ^ (h >> _U32(15))) * _U32(_P2)
    h = (h ^ (h >> _U32(13))) * _U32(_P3)
    return h ^ (h >> _U32(16))


@functools.partial(jax.jit, static_argnames=("seed",))
def xxh32_blocks(x: jax.Array, seed: int = CHECKSUM_SEED) -> jax.Array:
    """XXH32 of each row's big-endian u16 bytes -> (B,) uint32.

    ``x`` is (B, N) integer samples (any int dtype; low 16 bits hashed as
    two BE bytes each).  Pure XLA: a ``lax.scan`` over 16-byte stripes.
    Matches utils.xxh32.cmp_checksum row-for-row for any N >= 1.
    """
    B, N = x.shape
    n_bytes = 2 * N
    n_stripes = n_bytes // 16

    if N % 2:
        w = _lane_words(x[:, : N - 1])  # (B, (N-1)//2)
        s_last = x[:, -1].astype(_U32) & _U32(0xFFFF)
    else:
        w = _lane_words(x)
        s_last = None

    if n_stripes:
        stripes = jnp.moveaxis(
            w[:, : 4 * n_stripes].reshape(B, n_stripes, 4), 1, 0)

        init = jnp.broadcast_to(
            jnp.array([(seed + _P1 + _P2) & 0xFFFFFFFF,
                       (seed + _P2) & 0xFFFFFFFF,
                       seed & 0xFFFFFFFF,
                       (seed - _P1) & 0xFFFFFFFF], dtype=_U32),
            (B, 4))

        def step(acc, wv):
            return _rotl(acc + wv * _U32(_P2), 13) * _U32(_P1), None

        acc, _ = jax.lax.scan(step, init, stripes)
        h = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7)
             + _rotl(acc[:, 2], 12) + _rotl(acc[:, 3], 18))
    else:
        h = jnp.full((B,), (seed + _P5) & 0xFFFFFFFF, _U32)
    h = h + _U32(n_bytes)

    # 4-byte tail words after the last full stripe
    for j in range(4 * n_stripes, w.shape[1]):
        h = _rotl(h + w[:, j] * _U32(_P3), 17) * _U32(_P4)
    if s_last is not None:
        # final odd sample: two single BE bytes
        for b in (s_last >> _U32(8), s_last & _U32(0xFF)):
            h = _rotl(h + b * _U32(_P5), 11) * _U32(_P1)
    return _finalize(h)


def _bswap16(s):
    return ((s & _U32(0xFF)) << _U32(8)) | ((s >> _U32(8)) & _U32(0xFF))


def _xxh_kernel(N: int, B: int, seed: int, x_ref, out_ref):
    from jax.experimental import pallas as pl

    base = pl.program_id(0) * LANES
    row = jnp.minimum(base + jnp.arange(LANES, dtype=jnp.int32), B - 1) * N
    n_stripes = N // 8
    u = _UNROLL if n_stripes % _UNROLL == 0 else 1

    def stripe(s, acc):
        sw = [_bswap16(x_ref[row + (8 * s + j)].astype(_U32))
              for j in range(8)]
        return tuple(
            _rotl(a + (sw[2 * k] | (sw[2 * k + 1] << _U32(16)))
                  * _U32(_P2), 13) * _U32(_P1)
            for k, a in enumerate(acc))

    def body(i, acc):
        for k in range(u):
            acc = stripe(i * u + k, acc)
        return acc

    init = tuple(jnp.full((LANES,), v & 0xFFFFFFFF, _U32)
                 for v in (seed + _P1 + _P2, seed + _P2, seed, seed - _P1))
    a = jax.lax.fori_loop(0, n_stripes // u, body, init)
    out_ref[pl.ds(base, LANES)] = (_rotl(a[0], 1) + _rotl(a[1], 7)
                                   + _rotl(a[2], 12) + _rotl(a[3], 18))


def triton_xxh32_supported(N: int) -> bool:
    """The kernel needs whole 16-byte stripes: 2N % 16 == 0."""
    return N >= 8 and N % 8 == 0


@functools.partial(jax.jit, static_argnames=("seed", "interpret"))
def xxh32_blocks_triton(x: jax.Array, seed: int = CHECKSUM_SEED,
                        interpret: bool = False) -> jax.Array:
    """GPU XXH32: (B, N) samples -> (B,) u32, N % 8 == 0, any B >= 1."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    B, N = x.shape
    assert triton_xxh32_supported(N), "needs whole 16-byte stripes"
    assert B * N < 2 ** 31, "flat sample index must fit int32"
    B_pad = -(-B // LANES) * LANES
    h = pl.pallas_call(
        functools.partial(_xxh_kernel, N, B, seed),
        out_shape=jax.ShapeDtypeStruct((B_pad,), _U32),
        grid=(B_pad // LANES,),
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="airs_xxh32",
    )(x.astype(jnp.int32).reshape(-1))
    return _finalize(h[:B] + _U32(2 * N))


def use_device_checksum(n_samples: int) -> bool:
    """Should checksums of N-sample blocks be computed on the device?

    The single routing predicate for every caller (BatchCompressor,
    BatchDecompressor, chunked decompress verification); see
    ops/routing.checksum_path.
    """
    from . import routing

    return routing.checksum_path(routing.platform(), n_samples) != "host"


def checksum_blocks_device(x: jax.Array) -> jax.Array:
    """AIRSPACE per-block checksum on the routed device path."""
    from . import routing

    if routing.checksum_path(routing.platform(), x.shape[-1]) == "triton":
        return xxh32_blocks_triton(x)
    return xxh32_blocks(x)
