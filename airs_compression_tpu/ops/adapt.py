"""Adaptive per-block Golomb parameter selection (on device).

The reference uses fixed, caller-chosen parameters for a whole context
(lib/cmp.h cmp_params); this module adds an adaptive tier (adaptive per-block Golomb-Rice
parameter selection): each block picks its own Golomb parameter from the residual
statistics *after* preprocessing, and the chosen parameter travels in that
block's header (`encoder_param`), so the output remains a perfectly
ordinary AIRSPACE stream that any format decoder (including ours) decodes
without knowing adaptation happened.

Selection rule: for a geometric residual distribution the optimal Golomb
parameter satisfies g ~= -1/log2(p) with p = mu/(mu+1) where mu is the
mean of the zigzag-mapped residuals; the classic integer approximation is
g = max(1, round to power-of-two-ish of 0.69 * mu).

Two selection strategies share the exact per-candidate cost model (the
true coded bit count of the whole block, closed form, no packing):

* **fast** (default): the closed-form estimate g* = 0.69 * mu centers a
  small window of ladder candidates (default +/-2 neighbors) and only
  those are evaluated exactly — ~4x fewer elementwise passes than the
  full ladder.  The
  cost curve over the ladder is unimodal for geometric-like residuals,
  so the window argmin equals the full argmin on real data (asserted on
  random corpora by tests/test_adaptive.py); selection never affects
  decodability — the chosen parameter travels in the header either way.
* **exact**: the full-ladder argmin (``AIRS_ADAPTIVE_SELECT=exact``),
  also used automatically when the ladder is no bigger than the window.

All of this runs under jit on the device; only the ladder itself is static.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..utils.bits import (
    golomb_optimal_outlier_zero,
    golomb_upper_bound,
)
from . import golomb

__all__ = ["DEFAULT_LADDER", "code_lengths_for", "select_golomb_zero",
           "encode_codewords_dynamic", "code_lengths_for_multi",
           "select_golomb_multi", "encode_codewords_dynamic_multi",
           "code_lengths_dynamic", "code_lengths_dynamic_multi",
           "ladder_fast_div"]

_U32 = jnp.uint32

# Candidate Golomb parameters: powers of two cover the useful dynamic
# range for 16-bit residuals; odd values add fine-grained low-rate steps.
DEFAULT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                  192, 256, 384, 512, 1024, 2048, 4096)


def code_lengths_for(mapped: jax.Array, g_par: int) -> jax.Array:
    """Per-block total coded bits under GOLOMB_ZERO with ``g_par``.

    ``mapped`` is (..., N) uint32 zigzag values.  Mirrors the encoder's
    exact length arithmetic (golomb len for value+1, or escape len for
    mapped >= outlier), so the argmin over a ladder is the true optimum.
    """
    g_log2 = int(g_par).bit_length() - 1
    outlier = min(golomb_optimal_outlier_zero(g_par, 16),
                  golomb_upper_bound(g_par, False, 16))
    cutoff = (2 << g_log2) - g_par
    len0 = g_log2 + 1
    m = mapped.astype(jnp.int32)
    esc = m >= outlier
    v = jnp.where(esc, 0, m + 1)
    in_g0 = v < cutoff
    group = jnp.where(in_g0, 0, (v - cutoff) // g_par)
    ln = jnp.where(in_g0, len0, len0 + 1 + group)
    ln = jnp.where(esc, len0 + 16, ln)
    return jnp.sum(ln.astype(jnp.int32), axis=-1)


def ladder_fast_div(ladder: "tuple[int, ...]") -> bool:
    """True when every ladder value is 2^s or 3*2^s (the default ladder
    is), enabling :func:`_div_by_g` — a traced-divisor ``//`` lowers to
    a long software sequence (accelerators, GPUs included, have no
    integer-divide unit), while ``//3`` by a STATIC constant
    strength-reduces to a multiply."""
    return all((g & (g - 1)) == 0 or ((g % 3 == 0)
               and ((g // 3) & (g // 3 - 1)) == 0 and g // 3 > 0)
               for g in ladder)


def _div_by_g(v: jax.Array, g: jax.Array) -> jax.Array:
    """Exact ``v // g`` for g of the form 2^s or 3*2^s (traced g).

    One static //3 (strength-reduced by XLA) plus shifts and a select —
    no traced-divisor division anywhere.
    """
    lg = golomb.ilog2(g)
    is3 = (g & (g - _U32(1))) != _U32(0)
    s = lg - is3.astype(_U32)  # 3*2^s has ilog2 = s + 1
    return jnp.where(is3, (v // _U32(3)) >> s, v >> s)


def _group_div(vg: jax.Array, g: jax.Array, fast_div: bool) -> jax.Array:
    return (_div_by_g(vg, g) if fast_div
            else vg // jnp.maximum(g, _U32(1)))


def _select_window() -> int:
    """Half-width of the fast-selection candidate window (0 = exact)."""
    if os.environ.get("AIRS_ADAPTIVE_SELECT", "fast") == "exact":
        return 0
    return int(os.environ.get("AIRS_ADAPTIVE_WINDOW", "2"))


def _nearest_ladder_index(mu: jax.Array,
                          ladder: "tuple[int, ...]") -> jax.Array:
    """Nearest ladder index to the closed-form estimate g* = 0.69 * mu.

    len(ladder)-1 scalar comparisons against the static geometric
    midpoints of consecutive ladder entries.
    """
    g_est = 0.69 * mu
    idx = jnp.zeros(mu.shape, jnp.int32)
    for a, b in zip(ladder[:-1], ladder[1:]):
        idx = idx + (g_est > (a * b) ** 0.5).astype(jnp.int32)
    return idx


def _window_candidates(idx: jax.Array, ladder: "tuple[int, ...]", w: int):
    """(..., 2w+2) candidate parameters: ladder[0] plus ``idx``'s window.

    ``ladder[0]`` is always a candidate because the cost curve is
    bimodal for incompressible blocks — escaping (nearly) every sample
    at the smallest parameter beats any mid-ladder choice there, far
    from the mean-based estimate (ZERO's escape costs len0 + 16 bits,
    minimal at g=1).  Candidates are index-ascending and edge indices
    clip (duplicates are harmless): argmin tie-breaks to the first —
    lowest-index — winner, matching the exact path's tie-break.
    """
    cand_idx = jnp.clip(idx[..., None] + jnp.arange(-w, w + 1), 0,
                        len(ladder) - 1)
    cand_idx = jnp.concatenate(
        [jnp.zeros_like(idx)[..., None], cand_idx], axis=-1)
    return jnp.asarray(ladder, jnp.int32)[cand_idx]


def code_lengths_dynamic(mapped: jax.Array, g_par: jax.Array,
                         fast_div: bool = False) -> jax.Array:
    """Per-block GOLOMB_ZERO coded bits with traced parameters.

    ``g_par`` is (...,) int32 — one parameter per block; the derived
    outlier follows encode_codewords_dynamic's closed forms, so the
    lengths equal what those codewords would pack.  Broadcasts: a
    (..., C) ``g_par`` against (..., 1, N) mapped values scores C
    candidates per block in one fused pass.
    """
    g = g_par.astype(_U32)[..., None]
    g_log2 = golomb.ilog2(g)
    cutoff = (_U32(2) << g_log2) - g
    len0 = (g_log2 + _U32(1)).astype(jnp.int32)
    opt = cutoff + _U32(16) * g - _U32(1)
    upper = cutoff + (_U32(32) - len0.astype(_U32)) * g
    outlier = jnp.minimum(opt, upper)
    m = mapped
    esc = m >= outlier
    v = jnp.where(esc, _U32(0), m + _U32(1))
    in_g0 = v < cutoff
    vg = jnp.where(in_g0, _U32(0), v - cutoff)
    group = _group_div(vg, g, fast_div)
    ln = jnp.where(in_g0, len0, len0 + 1 + group.astype(jnp.int32))
    ln = jnp.where(esc, len0 + 16, ln)
    return jnp.sum(ln, axis=-1)


def select_golomb_zero(residuals: jax.Array,
                       ladder: "tuple[int, ...]" = DEFAULT_LADDER):
    """Pick the rate-optimal GOLOMB_ZERO parameter per block.

    Args:
      residuals: (..., N) int32 sign-extended i16 residuals (post
        preprocessing).
      ladder: static candidate parameters.

    Returns:
      (g_par (...,) int32 chosen parameter, total_bits (...,) int32 the
      winning payload bit count).
    """
    mapped = golomb.zigzag(residuals)
    w = _select_window()
    if w > 0 and 2 * w + 2 < len(ladder):
        mu = jnp.mean(mapped.astype(jnp.float32), axis=-1)
        cand = _window_candidates(
            _nearest_ladder_index(mu, ladder), ladder, w)
        costs = code_lengths_dynamic(
            mapped[..., None, :], cand,
            fast_div=ladder_fast_div(ladder)).astype(jnp.int32)
    else:
        costs = jnp.stack([code_lengths_for(mapped, g) for g in ladder],
                          axis=-1)
        cand = jnp.broadcast_to(jnp.asarray(ladder, jnp.int32),
                                costs.shape)
    best = jnp.argmin(costs, axis=-1)
    return (jnp.take_along_axis(cand, best[..., None], axis=-1)[..., 0],
            jnp.take_along_axis(costs, best[..., None], axis=-1)[..., 0])


def code_lengths_for_multi(mapped: jax.Array, g_par: int,
                           caller_outlier: int) -> jax.Array:
    """Per-block total coded bits under GOLOMB_MULTI with ``g_par``.

    The effective outlier is the caller's choice clamped to the 32-bit
    codeword upper bound for this parameter (encoder.c:185-224); escapes
    cost golomb(outlier+level) + (level+1)*2 raw bits (encoder.c:341-374).
    """
    g_log2 = int(g_par).bit_length() - 1
    outlier = min(caller_outlier, golomb_upper_bound(g_par, True, 16))
    cutoff = (2 << g_log2) - g_par
    len0 = g_log2 + 1
    m = mapped.astype(jnp.int32)
    esc = m >= outlier
    diff = jnp.where(esc, (m - outlier).astype(_U32), _U32(0))
    level = jnp.where(diff < _U32(4), _U32(0), golomb.ilog2(diff) >> _U32(1))
    gv = jnp.where(esc, _U32(outlier) + level, m.astype(_U32))
    in_g0 = gv < cutoff
    group = jnp.where(in_g0, _U32(0), (gv - _U32(cutoff)) // _U32(g_par))
    ln = jnp.where(in_g0, len0, len0 + 1 + group.astype(jnp.int32))
    ln = ln + jnp.where(esc, (level.astype(jnp.int32) + 1) * 2, 0)
    return jnp.sum(ln, axis=-1)


def _clamped_outlier_multi(g: jax.Array, caller_outlier: int) -> jax.Array:
    """min(caller outlier, MULTI 32-bit upper bound) with traced ``g``.

    Closed form of utils.bits.golomb_upper_bound(g, multi=True, 16):
    cutoff + (32 - len0) * g - 8 escape symbols (encoder.c:63-110).
    """
    g_log2 = golomb.ilog2(g)
    cutoff = (_U32(2) << g_log2) - g
    upper = cutoff + (_U32(31) - g_log2) * g - _U32(8)
    return jnp.minimum(_U32(caller_outlier), upper)


def code_lengths_dynamic_multi(mapped: jax.Array, g_par: jax.Array,
                               caller_outlier: int,
                               fast_div: bool = False) -> jax.Array:
    """Per-block GOLOMB_MULTI coded bits with traced parameters.

    Same broadcast contract as :func:`code_lengths_dynamic`; the
    effective outlier is the caller's, clamped per candidate parameter.
    """
    g = g_par.astype(_U32)[..., None]
    g_log2 = golomb.ilog2(g)
    cutoff = (_U32(2) << g_log2) - g
    len0 = (g_log2 + _U32(1)).astype(jnp.int32)
    outlier = _clamped_outlier_multi(g, caller_outlier)
    m = mapped
    esc = m >= outlier
    diff = jnp.where(esc, m - outlier, _U32(0))
    level = jnp.where(diff < _U32(4), _U32(0), golomb.ilog2(diff) >> _U32(1))
    gv = jnp.where(esc, outlier + level, m)
    in_g0 = gv < cutoff
    vg = jnp.where(in_g0, _U32(0), gv - cutoff)
    group = _group_div(vg, g, fast_div)
    ln = jnp.where(in_g0, len0, len0 + 1 + group.astype(jnp.int32))
    ln = ln + jnp.where(esc, (level.astype(jnp.int32) + 1) * 2, 0)
    return jnp.sum(ln, axis=-1)


def select_golomb_multi(residuals: jax.Array, caller_outlier: int,
                        ladder: "tuple[int, ...]" = DEFAULT_LADDER):
    """Pick the rate-optimal GOLOMB_MULTI parameter per block.

    Returns (g_par (...,) int32, outlier (...,) int32 the per-parameter
    clamped escape threshold, total_bits (...,) int32).
    """
    mapped = golomb.zigzag(residuals)
    w = _select_window()
    if w > 0 and 2 * w + 2 < len(ladder):
        # estimate from the value stream the Golomb coder actually sees:
        # escaped samples re-enter as the SMALL value outlier + level, so
        # the plain residual mean wildly overestimates the optimal g for
        # escape-heavy blocks (the caller's unclamped outlier is close
        # enough for the estimate; the window evaluation is exact)
        out = _U32(caller_outlier)
        esc = mapped >= out
        diff = jnp.where(esc, mapped - out, _U32(0))
        level = jnp.where(diff < _U32(4), _U32(0),
                          golomb.ilog2(diff) >> _U32(1))
        gv = jnp.where(esc, out + level, mapped)
        mu = jnp.mean(gv.astype(jnp.float32), axis=-1)
        cand = _window_candidates(
            _nearest_ladder_index(mu, ladder), ladder, w)
        costs = code_lengths_dynamic_multi(
            mapped[..., None, :], cand, caller_outlier,
            fast_div=ladder_fast_div(ladder)).astype(jnp.int32)
        best = jnp.argmin(costs, axis=-1)
        g_sel = jnp.take_along_axis(cand, best[..., None], axis=-1)[..., 0]
        outlier_sel = _clamped_outlier_multi(
            g_sel.astype(_U32), caller_outlier).astype(jnp.int32)
        return (g_sel, outlier_sel,
                jnp.take_along_axis(costs, best[..., None], axis=-1)[..., 0])
    costs = jnp.stack(
        [code_lengths_for_multi(mapped, g, caller_outlier) for g in ladder],
        axis=-1)
    best = jnp.argmin(costs, axis=-1)
    ladder_arr = jnp.asarray(ladder, jnp.int32)
    outliers = jnp.asarray(
        [min(caller_outlier, golomb_upper_bound(g, True, 16)) for g in ladder],
        jnp.int32)
    return (ladder_arr[best], outliers[best],
            jnp.take_along_axis(costs, best[..., None], axis=-1)[..., 0])


def encode_codewords_dynamic_multi(residuals: jax.Array, g_par: jax.Array,
                                   outlier: jax.Array,
                                   fast_div: bool = False):
    """GOLOMB_MULTI codewords with per-block traced parameter + outlier.

    Mirrors ops.golomb.encode_codewords (encoder_type=2) with traced
    per-block ``g_par``/``outlier`` arrays.  Returns (hi, lo, len) — the
    up-to-48-bit escape codewords span the (hi, lo) pair.
    """
    g = g_par.astype(_U32)[..., None]
    out = outlier.astype(_U32)[..., None]
    g_log2 = golomb.ilog2(g)
    cutoff = (_U32(2) << g_log2) - g
    len0 = (g_log2 + _U32(1)).astype(jnp.int32)

    m = golomb.zigzag(residuals)
    esc = m >= out
    diff = jnp.where(esc, m - out, _U32(0))
    level = jnp.where(diff < _U32(4), _U32(0), golomb.ilog2(diff) >> _U32(1))
    gv = jnp.where(esc, out + level, m)
    # dynamic-parameter Golomb codeword for gv (cw <= 32 bits by clamp)
    in_g0 = gv < cutoff
    vg = jnp.where(in_g0, _U32(0), gv - cutoff)
    group = _group_div(vg, g, fast_div)
    rem = vg - group * g
    unary = jnp.where(group >= _U32(32), _U32(0xFFFFFFFF),
                      (_U32(1) << jnp.minimum(group, _U32(31))) - _U32(1))
    sh = jnp.minimum(len0.astype(_U32) + _U32(1), _U32(31))
    cw_hi = (unary << sh) + (cutoff << _U32(1)) + rem
    cw = jnp.where(in_g0, gv, cw_hi)
    ln = jnp.where(in_g0, len0, len0 + 1 + group.astype(jnp.int32))
    raw_bits = (level + _U32(1)) * _U32(2)  # in [2, 16]
    hi = jnp.where(esc, cw >> (_U32(32) - raw_bits), _U32(0))
    lo = jnp.where(esc, (cw << raw_bits) | diff, cw)
    ln = jnp.where(esc, ln + raw_bits.astype(jnp.int32), ln)
    return hi, lo, ln


def _ilog2_dyn(x: jax.Array) -> jax.Array:
    return golomb.ilog2(x)


def encode_codewords_dynamic(residuals: jax.Array, g_par: jax.Array,
                             fast_div: bool = False):
    """GOLOMB_ZERO codewords with a per-block traced parameter.

    Like ops.golomb.encode_codewords but ``g_par`` is a (...,) int32
    array (one parameter per block) rather than a static constant; the
    derived outlier follows the reference's closed forms
    (encoder.c:63-182) elementwise.  Returns (hi, lo, len).
    """
    g = g_par.astype(_U32)[..., None]
    g_log2 = _ilog2_dyn(g)
    cutoff = (_U32(2) << g_log2) - g
    len0 = (g_log2 + _U32(1)).astype(jnp.int32)
    # optimal zero-escape outlier: cutoff + 16*g - 1, clamped to the
    # 32-bit-codeword upper bound (first_invalid = cutoff + (31-len0)*g)
    opt = cutoff + _U32(16) * g - _U32(1)
    # first value whose codeword would exceed 32 bits:
    # cutoff + (31 - ilog2(g)) * g = cutoff + (32 - len0) * g
    upper = cutoff + (_U32(32) - len0.astype(_U32)) * g
    outlier = jnp.minimum(opt, upper)

    m = golomb.zigzag(residuals)
    esc = m >= outlier
    v = jnp.where(esc, _U32(0), m + _U32(1))
    in_g0 = v < cutoff
    vg = jnp.where(in_g0, _U32(0), v - cutoff)
    group = _group_div(vg, g, fast_div)
    rem = vg - group * g
    unary = jnp.where(group >= _U32(32), _U32(0xFFFFFFFF),
                      (_U32(1) << jnp.minimum(group, _U32(31))) - _U32(1))
    sh = jnp.minimum(len0.astype(_U32) + _U32(1), _U32(31))
    cw_hi = (unary << sh) + (cutoff << _U32(1)) + rem
    cw = jnp.where(in_g0, v, cw_hi)
    ln = jnp.where(in_g0, len0, len0 + 1 + group.astype(jnp.int32))
    lo = jnp.where(esc, m, cw)
    ln = jnp.where(esc, len0 + 16, ln)
    return jnp.zeros_like(lo), lo, ln
