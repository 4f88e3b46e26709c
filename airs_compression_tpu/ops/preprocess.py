"""Batched on-device preprocessing kernels (forward + inverse).

Data-parallel re-design of the reference's sample-serial preprocessors
(lib/compress/preprocess.c): every method operates on whole batches of
blocks at once, shaped ``(B, N)`` int32 (16-bit sample values,
sign-extended), elementwise on device:

* DIFF   — shifted wraparound subtract (reference diff_process,
  preprocess.c:284-290); inverse is a wraparound cumulative sum.
* IWT    — multi-level lifting, one level per power-of-two stride
  (preprocess.c:140-221).  In subsequence coordinates each level is two
  data-parallel passes (odd/detail then even/approximation), so a level is
  a handful of rolls/shifts/wheres on a strided slice; the level count
  log2(N) is static under jit.
* MODEL  — subtract (model read as unsigned, preprocess.c:406-411) and the
  EMA update (cmp.c:120-142).

All arithmetic reproduces C int16 wraparound exactly (int32 compute with
explicit wrap) — parity is asserted against engine/host.py and the
reference C oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "wrap16",
    "diff_forward",
    "diff_inverse",
    "iwt_forward",
    "iwt_inverse",
    "model_forward",
    "model_inverse",
    "model_update",
    "preprocess_forward",
    "preprocess_inverse",
]


def wrap16(v: jax.Array) -> jax.Array:
    """Wrap int32 values into int16 range (C int16_t truncation)."""
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def diff_forward(x: jax.Array) -> jax.Array:
    """d[0]=x[0]; d[i]=wrap16(x[i]-x[i-1]) over the last axis."""
    prev = jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
    return wrap16(x - prev)


def diff_inverse(d: jax.Array) -> jax.Array:
    """Wraparound cumulative sum (mod 2^16 addition is associative)."""
    return wrap16(jnp.cumsum(d, axis=-1, dtype=jnp.int32))


def _iwt_level(xs: jax.Array, inverse: bool) -> jax.Array:
    """One lifting level over subsequence array ``xs`` of shape (..., m)."""
    m = xs.shape[-1]
    j = jax.lax.broadcasted_iota(jnp.int32, xs.shape, xs.ndim - 1)
    is_odd = (j & 1) == 1
    left = jnp.roll(xs, 1, axis=-1)
    right = jnp.roll(xs, -1, axis=-1)
    if not inverse:
        # odd (detail) pass: centre - floor2(left+right); last odd: centre-left
        det = jnp.where(j == m - 1, xs - left, xs - ((left + right) >> 1))
        y = jnp.where(is_odd, wrap16(det), xs)
        # even (approximation) pass
        yl = jnp.roll(y, 1, axis=-1)
        yr = jnp.roll(y, -1, axis=-1)
        app = xs + ((yl + yr) >> 2)
        app = jnp.where(j == 0, xs + (yr >> 1), app)
        app = jnp.where(j == m - 1, xs + (yl >> 1), app)
        return jnp.where(is_odd, y, wrap16(app))
    # inverse: undo even first (depends only on stored odd coefficients)
    app = xs - ((left + right) >> 2)
    app = jnp.where(j == 0, xs - (right >> 1), app)
    app = jnp.where(j == m - 1, xs - (left >> 1), app)
    x_even = jnp.where(is_odd, xs, wrap16(app))
    # then undo odd using recovered even samples
    xl = jnp.roll(x_even, 1, axis=-1)
    xr = jnp.roll(x_even, -1, axis=-1)
    det = jnp.where(j == m - 1, xs + xl, xs + ((xl + xr) >> 1))
    return jnp.where(is_odd, wrap16(det), x_even)


def _iwt_strides(n: int) -> "list[int]":
    strides, s = [], 1
    while s < n:
        strides.append(s)
        s <<= 1
    return strides


def iwt_forward(x: jax.Array) -> jax.Array:
    """Multi-level IWT decomposition over the last axis (int32 i16 values)."""
    n = x.shape[-1]
    out = x
    for s in _iwt_strides(n):
        sub = out[..., ::s]
        out = out.at[..., ::s].set(_iwt_level(sub, inverse=False))
    return out


def iwt_inverse(y: jax.Array) -> jax.Array:
    """Inverse multi-level IWT over the last axis."""
    n = y.shape[-1]
    out = y
    for s in reversed(_iwt_strides(n)):
        sub = out[..., ::s]
        out = out.at[..., ::s].set(_iwt_level(sub, inverse=True))
    return out


def model_forward(x: jax.Array, model: jax.Array) -> jax.Array:
    """r = wrap16(x - model_as_unsigned) (reference model_process)."""
    return wrap16(x - (model & 0xFFFF))


def model_inverse(r: jax.Array, model: jax.Array) -> jax.Array:
    return wrap16(r + (model & 0xFFFF))


def model_update(data: jax.Array, model: jax.Array, model_rate: jax.Array,
                 unsigned: bool) -> jax.Array:
    """EMA model update (reference update_model, cmp.c:120-142).

    ``data``/``model`` are int32 sign-extended i16 values; for U16 sources
    the weighted sum uses the unsigned representations.  Returns the new
    model, wrapped to i16 range.
    """
    if unsigned:
        d = data & 0xFFFF
        m = model & 0xFFFF
    else:
        d = data
        m = model
    w = m * model_rate + d * (16 - model_rate)
    return wrap16(w >> 4)


def preprocess_forward(method: int, x: jax.Array,
                       model: jax.Array | None = None) -> jax.Array:
    """Forward preprocessing dispatch; ``method`` is a static int."""
    if method == 0:
        return x
    if method == 1:
        return diff_forward(x)
    if method == 2:
        return iwt_forward(x)
    if method == 3:
        assert model is not None
        return model_forward(x, model)
    raise ValueError(f"unknown preprocessing {method}")


def preprocess_inverse(method: int, r: jax.Array,
                       model: jax.Array | None = None) -> jax.Array:
    if method == 0:
        return r
    if method == 1:
        return diff_inverse(r)
    if method == 2:
        return iwt_inverse(r)
    if method == 3:
        assert model is not None
        return model_inverse(r, model)
    raise ValueError(f"unknown preprocessing {method}")
