"""Closed-form Golomb codeword generation, elementwise on device.

The reference encodes one sample at a time through a branchy scalar routine
(lib/compress/encoder.c:303-378).  Here every sample's codeword is a
closed-form elementwise function of the zigzag-mapped value, so a whole
batch of blocks is computed at once: for each sample we produce a
(hi, lo, len) triple — the codeword's up-to-48 bits split across two uint32
words plus its bit length.  The Golomb parameter, outlier threshold, and
encoder type are static per compression config, so cutoff/log2 terms fold
into constants and the division by g_par becomes a multiply-shift.

Codeword construction (identical bits to the reference):
  value < cutoff:  value in (glog2+1) bits
  else:            group = (value-cutoff)/g;  rem = (value-cutoff)%g
                   [group ones] [(cutoff<<1)+rem in glog2+2 bits]
ZERO escape  (mapped >= outlier): Golomb(0) zeros + 16 raw bits, one write
MULTI escape (mapped >= outlier): Golomb(outlier+level) + (level+1)*2 raw
                                  bits of diff, level = ilog2(diff)/2
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["zigzag", "unzigzag", "ilog2", "golomb_codeword", "encode_codewords"]

_U32 = jnp.uint32


def zigzag(v: jax.Array) -> jax.Array:
    """ZigZag map of i16 residuals (int32 in) -> uint32 mapped in [0,65535].

    Mirrors reference map_to_unsigned with n_bits=16 (encoder.c:274-286).
    """
    return (((v << 1) ^ (v >> 15)) & 0xFFFF).astype(_U32)


def unzigzag(m: jax.Array) -> jax.Array:
    """Inverse zigzag: uint32 mapped -> int32 sign-extended i16 residual."""
    mi = m.astype(jnp.int32)
    return (mi >> 1) ^ -(mi & 1)


def ilog2(x: jax.Array) -> jax.Array:
    """floor(log2(x)) for uint32 x >= 1, exact (encoder.c:40-49)."""
    x = x.astype(_U32)
    r = jnp.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        m = x >= _U32(1 << shift)
        r = jnp.where(m, r + _U32(shift), r)
        x = jnp.where(m, x >> _U32(shift), x)
    return r


ilog2_u32 = ilog2


def golomb_codeword(v: jax.Array, g_par: int, g_log2: int):
    """Codewords for values known to be < golomb_upper_bound.

    ``g_par``/``g_log2`` are static Python ints.  Returns (cw: uint32,
    len: int32); lengths never exceed 32 (guaranteed by the outlier clamp,
    encoder.c:211-216).
    """
    cutoff = (2 << g_log2) - g_par
    len0 = g_log2 + 1
    in_g0 = v < _U32(cutoff)
    vg = jnp.where(in_g0, _U32(0), v - _U32(cutoff))
    group = (vg // _U32(g_par)).astype(_U32)  # static divisor -> mul/shift
    rem = vg - group * _U32(g_par)
    # min on int32: group <= 65535 so the cast is lossless
    gclamp = jnp.minimum(group.astype(jnp.int32), 31).astype(_U32)
    unary = jnp.where(group >= _U32(32), _U32(0xFFFFFFFF),
                      (_U32(1) << gclamp) - _U32(1))
    # unary << (len0+1) never overflows u32 for valid values (len <= 32)
    cw_hi = (unary << _U32(len0 + 1)) + _U32((cutoff << 1)) + rem
    cw = jnp.where(in_g0, v, cw_hi)
    ln = jnp.where(in_g0, len0, len0 + 1 + group.astype(jnp.int32))
    return cw, ln.astype(jnp.int32)


def encode_codewords(residuals: jax.Array, encoder_type: int, g_par: int,
                     outlier: int):
    """(hi, lo, len) codeword triples for a batch of residuals.

    ``residuals`` are int32 sign-extended i16 values; all config arguments
    are static.  Mirrors reference cmp_encoder_encode_s16
    (encoder.c:327-378) semantics exactly, vectorized.
    """
    if encoder_type == 0:  # UNCOMPRESSED: raw 16-bit residual
        lo = (residuals & 0xFFFF).astype(_U32)
        zeros = jnp.zeros_like(lo)
        return zeros, lo, jnp.full(residuals.shape, 16, jnp.int32)

    g_log2 = int(g_par).bit_length() - 1
    m = zigzag(residuals)
    if encoder_type == 1:  # GOLOMB_ZERO
        esc = m >= _U32(outlier)
        gv = jnp.where(esc, _U32(0), m + _U32(1))
        cw, ln = golomb_codeword(gv, g_par, g_log2)
        # escape: Golomb(0) zeros then 16 raw bits, combined (<=32 bits)
        lo = jnp.where(esc, m, cw)
        ln = jnp.where(esc, g_log2 + 1 + 16, ln)
        return jnp.zeros_like(lo), lo, ln

    if encoder_type == 2:  # GOLOMB_MULTI
        esc = m >= _U32(outlier)
        diff = jnp.where(esc, m - _U32(outlier), _U32(0))
        level = jnp.where(diff < _U32(4), _U32(0), ilog2(diff) >> _U32(1))
        gv = jnp.where(esc, _U32(outlier) + level, m)
        cw, ln = golomb_codeword(gv, g_par, g_log2)
        raw_bits = (level + _U32(1)) * _U32(2)  # in [2, 16]
        # combined (cw << raw_bits) | diff across a 48-bit (hi, lo) pair
        hi = jnp.where(esc, cw >> (_U32(32) - raw_bits), _U32(0))
        lo = jnp.where(esc, (cw << raw_bits) | diff, cw)
        ln = jnp.where(esc, ln + raw_bits.astype(jnp.int32), ln)
        return hi, lo, ln

    raise ValueError(f"unknown encoder type {encoder_type}")
