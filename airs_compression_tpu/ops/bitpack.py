"""Variable-length bit packing — the core of the device encoder.

The reference packs codewords through a sequential 64-bit cache
(lib/common/bitstream_writer.h:124-158).  That formulation is inherently
serial, so this module re-derives bit packing as a data-parallel problem:

1. An exclusive prefix sum of the per-code bit lengths yields every code's
   absolute bit offset in the stream.
2. A code of <= 48 bits starting at bit offset ``o`` touches at most three
   consecutive 32-bit output words (``o>>5`` .. ``o>>5``+2).  Funnel shifts
   produce each code's three word-aligned contributions.
3. Contributions from different codes to the same word occupy disjoint bit
   ranges, so integer ADD equals bitwise OR — and because uint32 addition
   is associative mod 2^32, *differences of prefix sums* of the
   contributions recover each word's total exactly.  One prefix sum per
   contribution slot plus a ``searchsorted`` over the (sorted) first-word
   indices therefore assembles the entire packed stream with no scatter
   and no sequential dependency.

Everything is uint32; no 64-bit emulation is needed.  The
stream is produced MSB-first in big-endian word order, exactly matching
the reference bitstream format.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["pack_codes", "pack_codes_tree", "merge_streams_tree",
           "exclusive_cumsum"]

_U32 = jnp.uint32


def exclusive_cumsum(x: jax.Array) -> jax.Array:
    """Exclusive cumulative sum along the last axis."""
    c = jnp.cumsum(x, axis=-1)
    return jnp.concatenate([jnp.zeros_like(c[..., :1]), c[..., :-1]], axis=-1)


def _funnel_u32(hi: jax.Array, lo: jax.Array, s: jax.Array) -> jax.Array:
    """uint32 of ((hi:lo) >> s) for s in [-95, 95]; negative s shifts left.

    ``hi:lo`` is a conceptual 64-bit value (hi = bits 32..63).  Shift
    amounts are clamped before use so no lane performs an out-of-range
    hardware shift.
    """
    s32 = s.astype(jnp.int32)
    # right shift path: (lo >> s) | (hi << (32-s)) for 0<=s<32, hi>>(s-32)
    # for 32<=s<64, 0 beyond
    sr = jnp.clip(s32, 0, 31).astype(_U32)
    srh = jnp.clip(s32 - 32, 0, 31).astype(_U32)
    # hi << (32-sr) with sr==0 lanes masked (shift amount clamped to 31)
    hi_shift = jnp.clip(32 - s32, 0, 31).astype(_U32)
    right_lo = (lo >> sr) | jnp.where(sr == 0, _U32(0), hi << hi_shift)
    right_hi = hi >> srh
    right = jnp.where(s32 < 32, right_lo, right_hi)
    right = jnp.where(s32 >= 64, _U32(0), right)
    # left shift path: lo << t for 0<t<32, 0 beyond (hi bits exceed u32)
    t = jnp.clip(-s32, 0, 31).astype(_U32)
    left = jnp.where(-s32 < 32, lo << t, _U32(0))
    return jnp.where(s32 >= 0, right, left)


def pack_codes(hi: jax.Array, lo: jax.Array, lens: jax.Array, n_words: int):
    """Pack variable-length codes into a big-endian 32-bit word stream.

    Args:
      hi, lo: uint32 (..., K) codeword bits (hi = bits above 32; MSB-first
        codes of length <= 48, "clean": bits above ``lens`` are zero).
      lens: int32 (..., K) per-code bit lengths (>= 0; zero-length codes
        contribute nothing).
      n_words: static output capacity in 32-bit words.

    Returns:
      (words: uint32 (..., n_words) big-endian bit stream,
       total_bits: int32 (...,) actual stream length in bits).
    """
    off = exclusive_cumsum(lens)
    total_bits = off[..., -1] + lens[..., -1]
    w0 = (off >> 5).astype(jnp.int32)
    r = (off & 31).astype(jnp.int32)

    # Three word-aligned contributions per code (word w0+k, k in 0..2).
    base = lens + r
    contrib = [_funnel_u32(hi, lo, base - 32 * (k + 1)) for k in range(3)]
    # zero-length codes must contribute nothing
    nz = lens > 0
    contrib = [jnp.where(nz, c, _U32(0)) for c in contrib]

    # Inclusive-from-zero prefix sums: P[..., i] = sum(contrib[..., :i]).
    def _psum(c):
        s = jnp.cumsum(c, axis=-1)
        return jnp.concatenate([jnp.zeros_like(s[..., :1]), s], axis=-1)

    pa, pb, pc = (_psum(c) for c in contrib)

    # For each output word w: codes with w0 == w contribute slot a,
    # w0 == w-1 slot b, w0 == w-2 slot c.  w0 is sorted, so the index
    # ranges come from searchsorted, and prefix-sum differences (exact mod
    # 2^32; disjoint bit ranges never carry) assemble the word.
    words_idx = jnp.arange(n_words, dtype=jnp.int32)

    def _one_block(w0_b, pa_b, pb_b, pc_b):
        edges = jnp.searchsorted(w0_b, words_idx, side="left").astype(jnp.int32)
        edges_r = jnp.searchsorted(w0_b, words_idx, side="right").astype(jnp.int32)

        def seg(p, shift):
            lo_i = jnp.where(words_idx - shift >= 0,
                             edges[jnp.maximum(words_idx - shift, 0)], 0)
            hi_i = jnp.where(words_idx - shift >= 0,
                             edges_r[jnp.maximum(words_idx - shift, 0)], 0)
            return p[hi_i] - p[lo_i]

        return seg(pa_b, 0) + seg(pb_b, 1) + seg(pc_b, 2)

    batch_shape = lens.shape[:-1]
    if batch_shape:
        flat = lambda x: x.reshape((-1,) + x.shape[len(batch_shape):])
        words = jax.vmap(_one_block)(flat(w0), flat(pa), flat(pb), flat(pc))
        words = words.reshape(batch_shape + (n_words,))
    else:
        words = _one_block(w0, pa, pb, pc)
    return words, total_bits


# ---------------------------------------------------------------------------
# Doubling-tree packer — the packer every device path uses.
#
# pack_codes above is scatter-free but inversion-heavy: assembling each
# output word needs searchsorted + gathers.  The tree packer below uses
# only shifts, selects, and concatenations — pure elementwise ops:
#
#   * level 0: each code is left-justified in its own C0-word buffer;
#   * each level pairwise-concatenates adjacent bitstreams:
#       out = A | (B >> lenA)
#     where the variable word-granular part of the shift (lenA / 32) is
#     performed as a barrel shifter — log2(C) CONDITIONAL CONSTANT word
#     shifts — and the bit-granular part (lenA % 32) is one per-row
#     variable funnel shift (elementwise);
#   * capacities grow with the worst-case bit width per level and are
#     clamped, so buffers track the config's actual entropy bound.
#
# After log2(K) levels the single remaining buffer IS the packed stream.
# No gather, no scatter, no sort, no searchsorted anywhere.
# ---------------------------------------------------------------------------


def _word_shift(buf: jax.Array, s: int) -> jax.Array:
    """Shift words toward higher indices by static s, zero-filling."""
    if s == 0:
        return buf
    pad = jnp.zeros(buf.shape[:-1] + (s,), buf.dtype)
    return jnp.concatenate([pad, buf[..., :-s]], axis=-1)


_LANE_SWITCH = 128  # move the word axis into lanes once it is this wide


def _shift_planes(planes, shift_bits, C_out, zeros):
    """Shift a list-of-planes bitstream right by per-row ``shift_bits``.

    Word-granular part: barrel shifter (log-step conditional constant
    list rotations); bit-granular part: one per-row variable funnel.
    """
    C = len(planes)
    ext = planes + [zeros] * (C_out - C)
    q = shift_bits >> 5
    t = 0
    while (1 << t) <= C_out:
        s = 1 << t
        shifted = [zeros] * min(s, C_out) + ext[: max(C_out - s, 0)]
        bit = ((q >> t) & 1) == 1
        ext = [jnp.where(bit, sh, orig) for sh, orig in zip(shifted, ext)]
        t += 1
    r = (shift_bits & 31).astype(jnp.uint32)
    rs = jnp.where(r == 0, jnp.uint32(0), jnp.uint32(32) - r)
    rnz = r != 0
    prev = [zeros] + ext[:-1]
    return [jnp.where(rnz, (w >> jnp.where(rnz, r, jnp.uint32(0)))
                      | jnp.where(rs == 0, jnp.uint32(0), p << rs), w)
            for w, p in zip(ext, prev)]


def _shift_array(buf, shift_bits, C_out):
    """Same as _shift_planes for the (..., M, C) array representation."""
    C = buf.shape[-1]
    pad = jnp.zeros(buf.shape[:-1] + (C_out - C,), jnp.uint32)
    ext = jnp.concatenate([buf, pad], axis=-1)
    q = (shift_bits >> 5)[..., None]
    t = 0
    while (1 << t) <= C_out:
        s = 1 << t
        sh = _word_shift(ext, min(s, C_out))
        ext = jnp.where((q >> t) & 1 == 1, sh, ext)
        t += 1
    r = (shift_bits & 31)[..., None].astype(jnp.uint32)
    prev = _word_shift(ext, 1)
    rs = jnp.where(r == 0, jnp.uint32(0), jnp.uint32(32) - r)
    return jnp.where(r == 0, ext,
                     (ext >> r) | jnp.where(rs == 0, jnp.uint32(0),
                                            prev << rs))


def _level_capacity(level_bits: int, naive: int) -> int:
    return min(naive, (level_bits + 31) // 32 + 3)


def _merge_level_list(words, ln, radix: int, C_out):
    """One radix-R merge level in list-of-planes representation.

    ``words`` is a list of C uint32 arrays, plane j holding word j of every
    group's buffer; codes/groups live in the (large, lane-mapped) minor
    array axis, so every operation is a full-width elementwise op.
    """
    C = len(words)
    groups = [[w[..., k::radix] for w in words] for k in range(radix)]
    lens = [ln[..., k::radix] for k in range(radix)]
    zeros = jnp.zeros_like(groups[0][0])
    out = groups[0] + [zeros] * (C_out - C)
    total = lens[0]
    for k in range(1, radix):
        shifted = _shift_planes(groups[k], total, C_out, zeros)
        out = [a | b for a, b in zip(out, shifted)]
        total = total + lens[k]
    return out, total


def _merge_level_array(buf, ln, radix: int, C_out):
    """One radix-R merge level in (..., M, C) representation."""
    groups = [buf[..., k::radix, :] for k in range(radix)]
    lens = [ln[..., k::radix] for k in range(radix)]
    C = buf.shape[-1]
    pad = jnp.zeros(groups[0].shape[:-1] + (C_out - C,), jnp.uint32)
    out = jnp.concatenate([groups[0], pad], axis=-1)
    total = lens[0]
    for k in range(1, radix):
        out = out | _shift_array(groups[k], total, C_out)
        total = total + lens[k]
    return out, total


def merge_streams_tree(words: jax.Array, bits: jax.Array, radix: int = 2):
    """Concatenate (..., M, C) left-justified bitstreams into one stream.

    ``words`` holds M (a power of two) already-packed word streams, each
    left-justified with ``bits[..., m]`` valid bits; the result is their
    in-order bit concatenation — log2(M) pairwise funnel-shift merge
    levels, the same machinery as :func:`pack_codes_tree`'s deep levels.
    Used to concatenate the B frames of a batch into one packed stream
    on device (models/stream._pack_stream_device).

    Returns (stream (..., M*C) uint32, total_bits (...,) int32).
    """
    m = words.shape[-2]
    assert m & (m - 1) == 0, "stream count must be a power of two"
    buf, ln = words, bits.astype(jnp.int32)
    while m > 1:
        r = radix if (m % radix == 0 and m >= radix) else 2
        buf, ln = _merge_level_array(buf, ln, r, r * buf.shape[-1])
        m //= r
    return buf[..., 0, :], ln[..., 0]


def pack_codes_tree(hi: jax.Array, lo: jax.Array, lens: jax.Array,
                    worst_bits: int, radix: int = 2):
    """Pack (..., K) codes (K a power of two) into a big-endian word stream.

    Args:
      hi, lo: uint32 codeword bits (hi = bits above 32), "clean".
      lens: int32 bit lengths in [0, worst_bits]; zero-length codes are
        no-ops (used for padding K to a power of two).
      worst_bits: static per-code maximum bit length (<= 64).

    Returns:
      (words: uint32 (..., C) left-justified stream, total_bits: int32
      (...,)); C = the static capacity for K codes of worst_bits bits.

    Design:
    * radix-R merge levels — each level concatenates R adjacent
      bitstreams (A | B>>lenA | ...); radix 2 is the default (radix 4
      halves the level count at the cost of more selects per level —
      not measured on the GPU);
    * variable shifts decompose into a barrel of log-step conditional
      CONSTANT word shifts plus one per-row funnel — no gather/scatter;
    * two-phase layout: early levels keep each buffer word as its own
      (..., M) plane so the big code axis stays lane-mapped; once buffers
      are >= 128 words the word axis itself moves into lanes.
    """
    K = lens.shape[-1]
    assert K & (K - 1) == 0, "K must be a power of two (pad with len-0 codes)"
    ln = lens.astype(jnp.int32)

    # level 0: left-justify every code
    if worst_bits <= 32:
        s = jnp.clip(32 - ln, 0, 31).astype(jnp.uint32)
        words = [jnp.where(ln > 0, lo << s, jnp.uint32(0))]
    else:
        sh_hi = jnp.clip(ln - 32, 0, 31).astype(jnp.uint32)   # len > 32
        sh_lo = jnp.clip(32 - ln, 0, 31).astype(jnp.uint32)   # len <= 32
        w0 = jnp.where(ln > 32,
                       (hi << (jnp.uint32(32) - sh_hi)) | (lo >> sh_hi),
                       jnp.where(ln > 0, lo << sh_lo, jnp.uint32(0)))
        w0 = jnp.where(ln == 32, lo, w0)
        sh_w1 = jnp.clip(64 - ln, 0, 31).astype(jnp.uint32)
        w1 = jnp.where(ln > 32, lo << sh_w1, jnp.uint32(0))
        words = [w0, w1]

    m = K
    level_bits = worst_bits
    # phase 1: list-of-planes while the word axis is narrow
    while m > 1:
        r = radix if (m % radix == 0 and m >= radix) else 2
        next_bits = level_bits * r
        C_out = _level_capacity(next_bits, r * len(words))
        if C_out >= _LANE_SWITCH:
            break
        words, ln = _merge_level_list(words, ln, r, C_out)
        level_bits = next_bits
        m //= r

    if m == 1:
        return jnp.stack(words, axis=-1)[..., 0, :], ln[..., 0]

    # phase 2: lane-mapped word axis
    buf = jnp.stack(words, axis=-1)
    while m > 1:
        r = radix if (m % radix == 0 and m >= radix) else 2
        level_bits *= r
        C_out = _level_capacity(level_bits, r * buf.shape[-1])
        buf, ln = _merge_level_array(buf, ln, r, C_out)
        m //= r
    return buf[..., 0, :], ln[..., 0]
