"""On-device block decoder — the capability the reference never implemented.

Golomb decoding is inherently bit-serial within a stream (each codeword's
position depends on all previous lengths), so the device decoder
parallelizes ACROSS blocks: B independent bit cursors advance in
lockstep, one codeword per sample step.  Each step is elementwise math —
count-leading-ones, funnel-shifted 64-bit windows, closed-form Golomb /
escape handling (inverting encoder.c:303-378) — plus a three-word gather
per block at its cursor.  The plain-XLA version is a ``lax.scan`` over
the steps (:func:`decode_blocks_xla`); on the GPU the same math runs as
one Triton kernel (ops/pallas_decode.py).

The decoded residual stream then runs through the batched inverse
preprocessors (ops/preprocess.py): wraparound cumsum for DIFF, inverse
lifting for IWT, model add for MODEL.

Throughput scales with the number of concurrent blocks (the only lever a
sequential entropy code allows); single-stream decode latency is the
format's price.  Cross-checked bit-exactly against the host decoder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import golomb, preprocess
from .encode import PassConfig

__all__ = ["decode_blocks_device", "decode_blocks_xla",
           "decode_blocks_uncompressed"]

_U32 = jnp.uint32


def _clz32(x: jax.Array) -> jax.Array:
    """Count leading zeros of uint32 (32 for x == 0)."""
    return jnp.where(x == 0, _U32(32), _U32(31) - golomb.ilog2_u32(x))


def _shl(x: jax.Array, s) -> jax.Array:
    """``x << s`` for any int32 ``s``: 0 outside [0, 32).

    XLA defines over-wide shifts as 0; Triton (LLVM) leaves them
    undefined, so every data-dependent shift amount in the decode math
    that the GPU kernel shares goes through these two helpers.
    """
    s = jnp.asarray(s, jnp.int32)
    ok = (s >= 0) & (s < 32)
    return jnp.where(ok, x << jnp.clip(s, 0, 31).astype(_U32), _U32(0))


def _shr(x: jax.Array, s) -> jax.Array:
    """Logical ``x >> s`` for any int32 ``s``: 0 outside [0, 32)."""
    s = jnp.asarray(s, jnp.int32)
    ok = (s >= 0) & (s < 32)
    return jnp.where(ok, x >> jnp.clip(s, 0, 31).astype(_U32), _U32(0))


def _funnel64(w0, w1, w2, r):
    """(hi, lo) of the 64-bit window starting ``r`` in [0, 32) bits into
    the three consecutive words ``w0, w1, w2``."""
    return _shl(w0, r) | _shr(w1, 32 - r), _shl(w1, r) | _shr(w2, 32 - r)


def _window64(words: jax.Array, bitpos: jax.Array):
    """(hi, lo) 64-bit window starting at ``bitpos`` for each block.

    ``words`` is (B, W) uint32; ``bitpos`` is (B,) int32.  Three words are
    gathered per block (indices clipped into the row) and funnel-shifted
    so the window's MSB is the bit at ``bitpos``.
    """
    W = words.shape[-1]
    wi = bitpos >> 5

    def take(i):
        idx = jnp.clip(i, 0, W - 1)[..., None]
        return jnp.take_along_axis(words, idx, axis=-1)[..., 0]

    return _funnel64(take(wi), take(wi + 1), take(wi + 2), bitpos & 31)


def _take_bits(hi: jax.Array, lo: jax.Array, start, count):
    """Extract ``count`` bits of the 64-bit window starting at ``start``
    (MSB-relative); count in [0, 32].  All operands per-lane dynamic."""
    # value = (window << start) >> (64 - count), in u32 pieces
    s = jnp.asarray(start, jnp.int32)
    top = jnp.where(s < 32, _shl(hi, s) | _shr(lo, 32 - s),
                    _shl(lo, s - 32))
    return _shr(top, 32 - jnp.asarray(count, jnp.int32))


def _golomb_terms(cfg: PassConfig, g_dyn=None, outlier_dyn=None):
    """Per-lane (g, g_log2, cutoff, outlier) decode constants.

    Static when the whole batch shares ``cfg``'s parameters; per-lane
    uint32/int32 arrays when the blocks carry their own ``encoder_param``/
    ``encoder_outlier`` in their headers (adaptive streams — the chosen
    parameter travels in the header, reference header_private.h:23-31).
    """
    if g_dyn is None:
        gl = int(cfg.g_par).bit_length() - 1
        g_par = _U32(cfg.g_par)
        g_log2 = jnp.int32(gl)
        cutoff = _U32((2 << gl) - cfg.g_par)
        outlier = _U32(cfg.outlier)
    else:
        g_par = g_dyn.astype(_U32)
        g_log2_u = golomb.ilog2_u32(g_par)
        g_log2 = g_log2_u.astype(jnp.int32)
        cutoff = (_U32(2) << g_log2_u) - g_par
        outlier = (outlier_dyn.astype(_U32) if outlier_dyn is not None
                   else _U32(cfg.outlier))
    return g_par, g_log2, cutoff, outlier


# poison added to a lane's end bit position when a malformed codeword is
# seen: guarantees (end + 7) // 8 exceeds any 24-bit compressed_size, so
# the callers' existing exhaustion checks reject the block (the device
# cannot raise per lane; the host decoders raise INT_BITSTREAM directly)
BAD_CODE_POISON_BITS = 1 << 29


def _decode_one(cfg: PassConfig, hi: jax.Array, lo: jax.Array,
                g_dyn=None, outlier_dyn=None):
    """Decode one codeword per block from its 64-bit window.

    Returns (mapped_or_raw_value: uint32, consumed_bits: int32,
    bad: bool) — ``bad`` marks a MALFORMED codeword: a Golomb part wider
    than the format's 32-bit codeword cap (reference encoder.h:17-30; no
    conforming encoder emits one) or a MULTI escape asking for more than
    32 raw bits.  Such codewords only occur in corrupt streams; the host
    decoders reject them, so the device must too (found by the fuzz
    soak: garbage-decoding them silently diverged from the host).
    ``g_dyn``/``outlier_dyn`` optionally supply per-lane parameters
    (broadcastable against ``hi``) for header-driven decode.
    """
    if cfg.enc_type == 0:  # UNCOMPRESSED: raw 16-bit residual
        v = hi >> _U32(16)
        return (v, jnp.full(hi.shape, 16, jnp.int32),
                jnp.zeros(hi.shape, bool))

    g_par, g_log2, cutoff, outlier = _golomb_terms(cfg, g_dyn, outlier_dyn)

    # unary quotient: leading ones
    q = _clz32(~hi).astype(jnp.int32)
    # remainder: g_log2 bits after the terminating zero
    r0 = _take_bits(hi, lo, q + 1, jnp.broadcast_to(g_log2, q.shape))
    long_form = r0 >= cutoff
    extra = _take_bits(hi, lo, q + 1 + g_log2, jnp.where(long_form, 1, 0))
    r_long = ((r0 << _U32(1)) | extra) - cutoff
    rem = jnp.where(long_form, r_long, r0)
    v = q.astype(_U32) * g_par + rem
    consumed = q + 1 + g_log2 + jnp.where(long_form, 1, 0)
    bad = consumed > 32  # Golomb part exceeds the 32-bit codeword cap

    if cfg.enc_type == 1:  # GOLOMB_ZERO
        esc = v == 0
        raw = _take_bits(hi, lo, consumed, jnp.where(esc, 16, 0))
        mapped = jnp.where(esc, raw, v - _U32(1))
        consumed = consumed + jnp.where(esc, 16, 0)
        # a mapped value over 16 bits is non-emittable (zigzag of an i16
        # is < 2^16) — malformed, like the host decoders reject
        bad = bad | (mapped > _U32(0xFFFF))
        return mapped, consumed, bad

    if cfg.enc_type == 2:  # GOLOMB_MULTI
        esc = v >= outlier
        level = jnp.where(esc, v - outlier, _U32(0))
        nbits = ((level + _U32(1)) * _U32(2)).astype(jnp.int32)
        bad = bad | (esc & (nbits > 32))
        nbits = jnp.minimum(nbits, 32)  # keep the window math in range
        diff = _take_bits(hi, lo, consumed, jnp.where(esc, nbits, 0))
        mapped = jnp.where(esc, outlier + diff, v)
        consumed = consumed + jnp.where(esc, nbits, 0)
        bad = bad | (mapped > _U32(0xFFFF))  # see GOLOMB_ZERO note
        return mapped, consumed, bad

    raise ValueError(f"unknown encoder type {cfg.enc_type}")


@functools.partial(jax.jit, static_argnames=("n_samples",))
def decode_blocks_uncompressed(words: jax.Array, n_samples: int):
    """Closed-form decode of NONE+UNCOMPRESSED frames (no scan needed).

    Such frames — notably the engine's uncompressed-fallback output
    (reference cmp.c:342-393) — have a 16-byte (4-word) header followed by
    word-aligned raw big-endian samples, so decoding is a slice + bit
    split.  Returns (B, N) int32 sign-extended i16 samples.
    """
    B = words.shape[0]
    n_payload = (n_samples + 1) // 2
    w = jax.lax.slice_in_dim(words, 4, 4 + n_payload, axis=-1)
    s_even = (w >> _U32(16)).astype(jnp.int32)
    s_odd = (w & _U32(0xFFFF)).astype(jnp.int32)
    vals = jnp.stack([s_even, s_odd], axis=-1).reshape(B, -1)[:, :n_samples]
    return ((vals & 0xFFFF) ^ 0x8000) - 0x8000


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples"))
def decode_blocks_device(cfg: PassConfig, words: jax.Array, model: jax.Array,
                         n_samples: int, g_dyn=None, outlier_dyn=None):
    """Decode (B, W) u32 frames (header included) -> (B, N) int32 samples.

    All blocks must share ``cfg``'s static shape (preprocessing, encoder
    type, header size); per-block Golomb parameters may be supplied as
    (B,) arrays ``g_dyn``/``outlier_dyn`` (header-driven decode of
    adaptive streams), in which case ``cfg.g_par`` must be an upper bound
    on every lane's parameter (it sizes the worst-case code width).
    ``model`` is consulted only for MODEL preprocessing.
    Returns (samples (B, N) int32 sign-extended i16, end_bitpos (B,) i32).

    On the GPU every batch routes through the Triton kernel
    (ops/pallas_decode.py), which runs the whole sample loop in one
    launch; elsewhere through :func:`decode_blocks_xla`, the plain
    reference.
    """
    from . import routing

    if routing.decode_path(routing.platform()) == "triton":
        from .pallas_decode import decode_blocks_triton

        return decode_blocks_triton(cfg, words, model, n_samples,
                                    g_dyn=g_dyn, outlier_dyn=outlier_dyn)
    return decode_blocks_xla(cfg, words, model, n_samples, g_dyn=g_dyn,
                             outlier_dyn=outlier_dyn)


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples"))
def decode_blocks_xla(cfg: PassConfig, words: jax.Array, model: jax.Array,
                      n_samples: int, g_dyn=None, outlier_dyn=None):
    """Plain-XLA lockstep decoder (``decode_blocks_device`` contract): a
    ``lax.scan`` over the N sample steps, all B cursors advanced at once."""
    B = words.shape[0]
    init = (jnp.full((B,), cfg.hdr_bits, jnp.int32),
            jnp.zeros((B,), bool))

    def step(carry, _):
        pos, badf = carry
        hi, lo = _window64(words, pos)
        val, consumed, bad = _decode_one(cfg, hi, lo, g_dyn, outlier_dyn)
        return (pos + consumed, badf | bad), val

    (end_pos, badf), vals = jax.lax.scan(step, init, None,
                                         length=n_samples)
    # poisoned end positions make the callers' exhaustion checks reject
    # blocks containing malformed codewords (see _decode_one)
    end_pos = end_pos + jnp.where(badf, BAD_CODE_POISON_BITS, 0)
    vals = jnp.moveaxis(vals, 0, -1)  # (B, N)

    if cfg.enc_type == 0:
        residuals = ((vals.astype(jnp.int32) & 0xFFFF) ^ 0x8000) - 0x8000
    else:
        residuals = golomb.unzigzag(vals)
    samples = preprocess.preprocess_inverse(
        cfg.prep, residuals,
        model if cfg.prep == 3 else None)
    return samples, end_pos
