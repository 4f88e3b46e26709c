"""Lockstep Golomb decoder as one GPU kernel (Pallas, Triton route).

Golomb decoding is bit-serial inside a block, so the parallelism is
across blocks: one thread per block.  The plain XLA version
(ops/decode.py) is a ``lax.scan`` over the N samples, which on a GPU
costs at least one kernel launch per sample step.  This kernel runs the
whole serial loop inside one launch:

* each program owns ``LANES`` consecutive blocks (one warp, one lane per
  block); the frame words are a flat (B * C,) array in device memory;
* a ``fori_loop`` over samples keeps each lane's bit cursor and
  malformed-codeword flag in registers; every step gathers the lane's
  three words at its cursor (L1/L2-resident: a lane walks its own row
  forward), funnel-shifts the 64-bit window and decodes one codeword
  with the exact closed forms of the XLA path (ops/decode._decode_one);
* decoded values are stored sample-major, (N, B_pad), so every store of
  a warp is one contiguous 128-byte row; XLA transposes back and runs
  the inverse preprocessing.

The decode math is shared with the XLA scan, so the two are bit-identical
on every input, malformed streams included (``BAD_CODE_POISON_BITS``
poisoning, clipped word indices).  Tested against the scan in interpret
mode on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import golomb, preprocess
from .decode import BAD_CODE_POISON_BITS, _decode_one, _funnel64
from .encode import PassConfig

__all__ = ["decode_blocks_triton", "LANES"]

_U32 = jnp.uint32
LANES = 32    # blocks per program: one warp, one lane per block
_WARPS = 1


def _kernel(cfg: PassConfig, n_samples: int, B: int, C: int, B_pad: int,
            dynamic: bool, words_ref, *refs):
    if dynamic:
        g_ref, o_ref, out_ref, end_ref = refs
    else:
        out_ref, end_ref = refs
    base = pl.program_id(0) * LANES
    lane = jnp.minimum(base + jnp.arange(LANES, dtype=jnp.int32), B - 1)
    row = lane * C
    g_lane = o_lane = None
    if dynamic:
        g_lane = g_ref[lane]
        o_lane = o_ref[lane]

    def word(i):
        return words_ref[row + jnp.clip(i, 0, C - 1)]

    def step(i, carry):
        pos, bad = carry
        wi = pos >> 5
        hi, lo = _funnel64(word(wi), word(wi + 1), word(wi + 2), pos & 31)
        val, used, b = _decode_one(cfg, hi, lo, g_lane, o_lane)
        out_ref[pl.ds(i * B_pad + base, LANES)] = val
        return pos + used, bad | b.astype(jnp.int32)

    init = (jnp.full((LANES,), cfg.hdr_bits, jnp.int32),
            jnp.zeros((LANES,), jnp.int32))
    pos, bad = jax.lax.fori_loop(0, n_samples, step, init)
    end_ref[pl.ds(base, LANES)] = pos + bad * BAD_CODE_POISON_BITS


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples",
                                             "interpret"))
def decode_blocks_triton(cfg: PassConfig, words: jax.Array,
                         model: jax.Array, n_samples: int,
                         g_dyn=None, outlier_dyn=None,
                         interpret: bool = False):
    """Drop-in for ``decode_blocks_device`` (same contract) on the GPU.

    ``words`` is (B, C) uint32 whole frames (header included), any
    B >= 1.  ``g_dyn``/``outlier_dyn`` optionally carry per-block Golomb
    parameters (header-driven decode of adaptive streams).  Returns
    (samples (B, N) int32, end_bitpos (B,) int32).
    """
    B, C = words.shape
    assert B * C < 2 ** 31, "flat word index must fit int32"
    B_pad = -(-B // LANES) * LANES
    dynamic = g_dyn is not None
    ins = [words.reshape(-1)]
    if dynamic:
        if outlier_dyn is None:
            outlier_dyn = jnp.full((B,), cfg.outlier, _U32)
        ins += [g_dyn.astype(_U32), outlier_dyn.astype(_U32)]
    out, end_pos = pl.pallas_call(
        functools.partial(_kernel, cfg, n_samples, B, C, B_pad, dynamic),
        out_shape=(jax.ShapeDtypeStruct((n_samples * B_pad,), _U32),
                   jax.ShapeDtypeStruct((B_pad,), jnp.int32)),
        grid=(B_pad // LANES,),
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="airs_decode",
    )(*ins)
    vals = out.reshape(n_samples, B_pad)[:, :B].T
    end_pos = end_pos[:B]

    if cfg.enc_type == 0:
        residuals = ((vals.astype(jnp.int32) & 0xFFFF) ^ 0x8000) - 0x8000
    else:
        residuals = golomb.unzigzag(vals)
    samples = preprocess.preprocess_inverse(
        cfg.prep, residuals, model if cfg.prep == 3 else None)
    return samples, end_pos
