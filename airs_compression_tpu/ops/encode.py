"""Fused on-device block encoder: preprocess -> codewords -> bit-pack -> frame.

One call encodes a whole batch of blocks (B, N) into complete AIRSPACE
frames (header + payload [+ checksum]) as big-endian 32-bit word streams,
entirely on device.  Differences from the reference engine
(lib/compress/cmp.c:213-338) that make it data-parallel:

* The per-sample loop with two indirect calls becomes three fused
  elementwise stages (ops/preprocess, ops/golomb, ops/bitpack).
* The reference writes a placeholder header, encodes, then rewinds to patch
  ``compressed_size`` (cmp.c:321-334).  Here the bit lengths are known
  before packing, so the final header is assembled up front and the whole
  frame is packed in one pass — no rewind.
* The model update (cmp.c:296-312) is a vectorized select + EMA.
* The uncompressed fallback probe (cmp.c:342-393) reduces to a size
  comparison: the probe "fails with DST_TOO_SMALL" exactly when the
  compressed frame would exceed the uncompressed frame size, so the
  fallback decision is ``compressed_size > uncompressed_size`` and both
  candidate frames are produced branch-free, selected per block.

All compression parameters are static (they select code paths and fold
into constants); batch contents, sequence number, identifiers, model state
and checksums are traced.

The host-side wrapper (models/stream.py) handles identifier draws, byte
extraction, and bit-exactness bookkeeping for the fallback path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..format.header import CMP_VERSION_NUMBER
from ..format.params import CmpParams, EncoderType, Preprocessing
from ..utils.bits import derive_encoder_outlier
from . import bitpack, golomb, preprocess

__all__ = ["PassConfig", "make_pass_config", "encode_blocks_device", "worst_case_words"]

_U32 = jnp.uint32

_HDR_BASIC_BITS = 128   # 16-byte header
_HDR_EXT_BITS = 176     # 22-byte header with extension


class PassConfig:
    """Static configuration of one encode pass (hashable for jit)."""

    def __init__(self, prep: int, enc_type: int, g_par: int, outlier: int,
                 checksum: bool, model_rate: int, model_needed: bool,
                 unsigned_model: bool, raw_outlier: "int | None" = None):
        self.prep = prep
        self.enc_type = enc_type
        self.g_par = g_par
        self.outlier = outlier
        # the caller's outlier before the per-parameter upper-bound clamp
        # (needed by the adaptive tier, which re-clamps per candidate g)
        self.raw_outlier = outlier if raw_outlier is None else raw_outlier
        self.checksum = checksum
        self.model_rate = model_rate
        self.model_needed = model_needed
        self.unsigned_model = unsigned_model
        self.has_ext = prep != 0 or enc_type != 0
        self.hdr_bits = _HDR_EXT_BITS if self.has_ext else _HDR_BASIC_BITS

    def _key(self):
        return (self.prep, self.enc_type, self.g_par, self.outlier,
                self.checksum, self.model_rate, self.model_needed,
                self.unsigned_model, self.raw_outlier)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, PassConfig) and self._key() == other._key()

    @property
    def worst_bits_per_sample(self) -> int:
        if self.enc_type == int(EncoderType.UNCOMPRESSED):
            return 16
        if self.enc_type == int(EncoderType.GOLOMB_ZERO):
            return (int(self.g_par).bit_length() - 1) + 1 + 16
        return 48  # MULTI: 32-bit codeword + 16 raw bits


def make_pass_config(params: CmpParams, secondary: bool,
                     unsigned_model: bool) -> PassConfig:
    """Derive the static pass config (mirrors cmp.c:228-248 selection)."""
    prep, enc_t, enc_p, out_p = params.pass_params(secondary)
    outlier = derive_encoder_outlier(int(enc_t), enc_p, out_p)
    return PassConfig(int(prep), int(enc_t), enc_p, outlier,
                      bool(params.checksum_enabled), params.model_rate,
                      params.model_is_needed(), unsigned_model,
                      raw_outlier=out_p)


def default_cap_bits(cfg: PassConfig) -> "int | None":
    """Default entropy clamp (bits per code) for frame buffers under ``cfg``.

    Policy: half the worst-case code length (floor 8 bits/code) — several
    times the entropy of typical detector residuals, so overflows (which
    cost a transparent full-capacity re-encode) are rare, while the frame
    buffer the host fetches shrinks ~2x (:func:`clamped_frame_words`).
    """
    if cfg.enc_type == int(EncoderType.UNCOMPRESSED):
        return None
    if cfg.enc_type == int(EncoderType.GOLOMB_MULTI):
        # clamp the COMMON code class, not the 48-bit escape worst case:
        # a MULTI normal code is the same Golomb family as ZERO's, so the
        # budget derives from the equivalent ZERO width; escape-heavy
        # blocks overflow the clamp and transparently re-encode at full
        # capacity
        zero_like = (int(cfg.g_par).bit_length() - 1) + 1 + 16
        return max(8, zero_like // 2 - 1)
    return max(8, cfg.worst_bits_per_sample // 2 - 1)


def worst_case_words(cfg: PassConfig, n: int) -> int:
    """Static output capacity (32-bit words) for n samples under cfg."""
    bits = cfg.hdr_bits + cfg.worst_bits_per_sample * n + 7 + 32
    return (bits + 31) // 32 + 1


# Entropy-clamp slack: a clamped payload budget is cap_bits per code plus
# this many bits, covering a handful of near-worst codes in one block.
_CAP_FLOOR_BITS = 64


def clamped_payload_words(worst_bits: int, cap_bits: "int | None",
                          n: int) -> int:
    """Payload words a frame buffer holds for n codes under the clamp.

    Unclamped: the worst case n * worst_bits.  Clamped: a linear entropy
    budget cap_bits * n plus a fixed floor, with n rounded up to the
    packer's power-of-two code count.
    """
    K = max(16, 1 << max(n - 1, 0).bit_length())
    bits = worst_bits * K
    if cap_bits is not None:
        bits = min(bits, _CAP_FLOOR_BITS + cap_bits * K)
    return (bits + 31) // 32


def clamped_frame_words(cfg: PassConfig, n: int, cap_bits: "int | None") -> int:
    """Frame capacity (words) under an entropy clamp.

    The frame buffer only needs the clamped payload plus header/padding/
    checksum — typically ~2.4x smaller than :func:`worst_case_words`, and
    the host fetches the whole buffer for its row gather.  Frames whose
    data exceeds the clamp are flagged ``ok=False`` by the encoder and
    must be re-encoded at full capacity.
    """
    if cap_bits is None:
        return worst_case_words(cfg, n)
    c_payload = clamped_payload_words(cfg.worst_bits_per_sample, cap_bits, n)
    words = (cfg.hdr_bits + 31) // 32 + c_payload + 3  # tail + checksum slack
    return min(words, worst_case_words(cfg, n))


def _header_words(cfg: PassConfig, compressed_size, original_size, id_hi,
                  id_lo, seq, enc_param_dyn=None, outlier_dyn=None):
    """Per-block header directly as big-endian u32 words.

    The header layout is fixed (cmp_header.h:26-51), so each of the 4 (or
    5.5 with the extension) words is a closed-form expression — no bit
    packing needed.  Returns a list of (B,) uint32 planes.  The adaptive
    encoder passes per-block ``enc_param_dyn`` / ``outlier_dyn`` arrays.
    """
    csize = compressed_size.astype(_U32)
    osize = _U32(original_size)
    version = _U32((1 << 15) | CMP_VERSION_NUMBER)
    method = ((cfg.prep & 0xF) << 4) | ((1 if cfg.checksum else 0) << 3) | (cfg.enc_type & 0x7)
    w0 = (version << _U32(16)) | (csize >> _U32(8))
    w1 = ((csize & _U32(0xFF)) << _U32(24)) | osize
    w2 = (id_hi.astype(_U32) << _U32(8)) | (id_lo.astype(_U32) >> _U32(16))
    w3 = ((id_lo.astype(_U32) & _U32(0xFFFF)) << _U32(16)) \
        | ((seq.astype(_U32) & _U32(0xFF)) << _U32(8)) | _U32(method)
    words = [w0, w1, w2, w3]
    if cfg.has_ext:
        model_rate = cfg.model_rate if cfg.prep == int(Preprocessing.MODEL) else 0
        if cfg.enc_type != 0:
            enc_param = (enc_param_dyn.astype(_U32) if enc_param_dyn is not None
                         else _U32(cfg.g_par))
            enc_outlier = (outlier_dyn.astype(_U32) if outlier_dyn is not None
                           else _U32(cfg.outlier))
        else:
            enc_param = _U32(0)
            enc_outlier = _U32(0)
        w4 = _U32(model_rate << 24) | (enc_param << _U32(8)) \
            | (enc_outlier >> _U32(16))
        w5 = (enc_outlier & _U32(0xFFFF)) << _U32(16)
        b = jnp.broadcast_to
        words += [b(w4, w0.shape), b(w5, w0.shape)]
    return words


def _encode_one_pass(cfg: PassConfig, x: jax.Array, model: jax.Array,
                     seq: jax.Array, id_hi: jax.Array, id_lo: jax.Array,
                     checksum: jax.Array, n_words: int,
                     cap_bits: "int | None" = None):
    """Encode (B, N) int32 samples under a static pass config.

    Pipeline: preprocess -> closed-form codewords -> doubling-tree payload
    pack -> closed-form header words -> constant-shift frame assembly with
    the optional checksum placed by an iota mask.  Everything is shifts,
    selects and concatenations — no gather/scatter.

    Returns (words (B, n_words) u32, size_bytes (B,) i32); with
    ``cap_bits`` set (entropy-clamped ``n_words``) additionally a (B,)
    bool ``ok`` — False marks blocks whose frame did not fit the buffer
    and must be re-encoded at full capacity (their ``size_bytes`` are
    exact regardless).
    """
    B, N = x.shape
    residuals = preprocess.preprocess_forward(
        cfg.prep, x, model if cfg.prep == int(Preprocessing.MODEL) else None)
    wb = cfg.worst_bits_per_sample
    if cfg.enc_type == int(EncoderType.UNCOMPRESSED):
        # fixed 16-bit codes need no tree: word j = (code 2j << 16) | code
        # 2j+1, exactly the packed layout the tree would produce
        r = (residuals & 0xFFFF).astype(_U32)
        if N % 2:
            r = jnp.concatenate([r, jnp.zeros((B, 1), _U32)], axis=-1)
        payload = (r[:, 0::2] << _U32(16)) | r[:, 1::2]
        payload_bits = jnp.full((B,), 16 * N, jnp.int32)
        out = _assemble_frames(cfg, payload, payload_bits, N, seq, id_hi,
                               id_lo, checksum, n_words)
        # ok = frame actually fit the (possibly clamped) buffer; assembly
        # truncates at n_words, so an oversized frame must be flagged
        return out if cap_bits is None else out + (out[1] <= n_words * 4,)
    hi, lo, lens = golomb.encode_codewords(residuals, cfg.enc_type,
                                           cfg.g_par, cfg.outlier)
    out = _finish_frames(cfg, hi, lo, lens, seq, id_hi, id_lo, checksum,
                         n_words, wb, cap_bits=cap_bits)
    return out[:2] if cap_bits is None else out


def _finish_frames(cfg: PassConfig, hi, lo, lens, seq, id_hi, id_lo,
                   checksum, n_words: int, worst_bits: int,
                   enc_param_dyn=None, outlier_dyn=None,
                   cap_bits: "int | None" = None):
    """Pack + frame assembly shared by the static and adaptive encoders.

    Always returns (words, sizes, ok).  With ``cap_bits`` set (clamped
    frame buffers), ok is False for any block whose assembled frame
    exceeds ``n_words``: ``_assemble_frames`` truncates frames there, and
    they would otherwise be reported corrupt-but-ok.
    """
    B, N = lens.shape
    # pad the code count to a power of two with zero-length codes
    K = 1 << (N - 1).bit_length() if N > 1 else 1
    if K != N:
        padw = jnp.zeros((B, K - N), _U32)
        hi = jnp.concatenate([hi, padw], axis=-1)
        lo = jnp.concatenate([lo, padw], axis=-1)
        lens = jnp.concatenate([lens, jnp.zeros((B, K - N), jnp.int32)],
                               axis=-1)
    payload, payload_bits = bitpack.pack_codes_tree(hi, lo, lens, worst_bits)
    words, sizes = _assemble_frames(cfg, payload, payload_bits, N, seq,
                                    id_hi, id_lo, checksum, n_words,
                                    enc_param_dyn, outlier_dyn)
    ok = jnp.ones((B,), bool) if cap_bits is None else sizes <= n_words * 4
    return words, sizes, ok


def _assemble_frames(cfg: PassConfig, payload, payload_bits, N: int, seq,
                     id_hi, id_lo, checksum, n_words: int,
                     enc_param_dyn=None, outlier_dyn=None):
    """Closed-form frame assembly from a packed payload word stream."""
    B = payload.shape[0]
    bits = cfg.hdr_bits + payload_bits
    if cfg.checksum:
        pad = (-bits) % 8
        total_bits = bits + pad + 32
    else:
        total_bits = bits
    size_bytes = ((total_bits + 7) >> 3).astype(jnp.int32)

    hdr = _header_words(cfg, size_bytes, 2 * N, id_hi, id_lo, seq,
                        enc_param_dyn, outlier_dyn)
    hdr_full_words = cfg.hdr_bits // 32      # 4 (basic) or 5 (ext)
    hdr_rem = cfg.hdr_bits % 32              # 0 or 16
    if hdr_rem == 0:
        # header is word-aligned: simple concatenation
        body = [w[..., None] for w in hdr] + [payload]
    else:
        # payload shifted right by hdr_rem bits, first part ORed into the
        # header's half-filled last word
        p_prev = jnp.concatenate(
            [jnp.zeros((B, 1), _U32), payload[..., :-1]], axis=-1)
        p_sh = (payload >> _U32(hdr_rem)) | (p_prev << _U32(32 - hdr_rem))
        tail = (payload[..., -1] << _U32(32 - hdr_rem))[..., None]
        body = ([w[..., None] for w in hdr[:hdr_full_words]]
                + [(hdr[hdr_full_words] | p_sh[..., 0])[..., None],
                   p_sh[..., 1:], tail])
    out = jnp.concatenate(body, axis=-1)
    if out.shape[-1] < n_words:
        out = jnp.concatenate(
            [out, jnp.zeros((B, n_words - out.shape[-1]), _U32)], axis=-1)
    else:
        out = out[..., :n_words]

    if cfg.checksum:
        # place the 32-bit checksum at the byte-aligned end (one-hot mask)
        cs_bit = bits + pad                      # absolute bit offset
        aw = (cs_bit >> 5)[..., None]            # (B, 1)
        off = (cs_bit & 31)[..., None].astype(_U32)
        iota = jnp.arange(n_words, dtype=jnp.int32)[None, :]
        cs = checksum.astype(_U32)[..., None]
        c0 = cs >> off
        c1 = jnp.where(off == 0, _U32(0),
                       cs << jnp.where(off == 0, _U32(0), _U32(32) - off))
        out = out | jnp.where(iota == aw, c0, _U32(0)) \
                  | jnp.where(iota == aw + 1, c1, _U32(0))
    return out, size_bytes


@functools.partial(jax.jit, static_argnames=("cfg", "fallback_cfg",
                                              "n_words", "cap_bits"))
def encode_blocks_device(cfg: PassConfig, fallback_cfg, x: jax.Array,
                         model: jax.Array, seq: jax.Array, id_hi: jax.Array,
                         id_lo: jax.Array, checksum: jax.Array,
                         n_words: int, cap_bits: "int | None" = None):
    """Full engine pass over a batch of blocks.

    Args:
      cfg: static PassConfig of the selected pass.
      fallback_cfg: static PassConfig for the uncompressed fallback, or
        None when the fallback is disabled.
      x: (B, N) int32 sign-extended i16 samples.
      model: (B, N) int32 model state (ignored unless cfg uses MODEL).
      seq: (B,) int32 per-block sequence numbers (written to headers).
      id_hi, id_lo: (B,) uint32 identifier halves (bits 47..24 / 23..0).
      checksum: (B,) uint32 XXH32 values (zeros when disabled).
      n_words: static output word capacity.
      cap_bits: entropy clamp that sized ``n_words`` (see
        :func:`clamped_frame_words`) — adds a fourth ``pack_ok`` (B,) bool
        output; re-encode blocks with ``pack_ok == False`` at full
        capacity.

    Returns:
      words (B, n_words) u32 big-endian frames, sizes (B,) i32,
      fell_back (B,) bool [, pack_ok (B,) bool when cap_bits is set].
    """
    B, N = x.shape
    if cap_bits is not None:
        words, sizes, pack_ok = _encode_one_pass(
            cfg, x, model, seq, id_hi, id_lo, checksum, n_words,
            cap_bits=cap_bits)
    else:
        words, sizes = _encode_one_pass(cfg, x, model, seq, id_hi, id_lo,
                                        checksum, n_words)
        pack_ok = None

    if fallback_cfg is not None:
        # Probe criterion (cmp.c:362-372): the clamped-capacity run fails
        # exactly when the frame exceeds the uncompressed frame size.
        unc_size = 16 + 2 * N + (4 if cfg.checksum else 0)
        fell_back = sizes > unc_size

        # The fallback frames are only materialized when some block
        # actually fell back: lax.cond executes one branch at runtime, so
        # the common all-compressible batch pays nothing for having the
        # fallback armed (the reference pays its probe per block,
        # cmp.c:362-392; here the probe is the size comparison above).
        def _mk_fb(args):
            x_, model_, seq_ = args
            return _encode_one_pass(
                fallback_cfg, x_, model_, jnp.zeros_like(seq_), id_hi,
                id_lo, checksum, n_words)

        def _mk_none(args):
            return (jnp.zeros((B, n_words), _U32),
                    jnp.zeros((B,), jnp.int32))

        fb_words, fb_sizes = jax.lax.cond(
            jnp.any(fell_back), _mk_fb, _mk_none, (x, model, seq))
        words = jnp.where(fell_back[:, None], fb_words, words)
        sizes = jnp.where(fell_back, fb_sizes, sizes)
    else:
        fell_back = jnp.zeros((B,), bool)
    if pack_ok is None:
        return words, sizes, fell_back
    # A block that fell back is served by the (tree-free) uncompressed
    # frame, so a clamped-pack overflow there is moot — but only if the
    # uncompressed frame itself fits the (possibly clamped) buffer;
    # otherwise _assemble_frames truncated it and the block must stay
    # flagged for a full-capacity re-encode.
    unc_size = 16 + 2 * N + (4 if cfg.checksum else 0)
    fb_fits = unc_size <= n_words * 4  # static
    return words, sizes, fell_back, jnp.where(fell_back, fb_fits, pack_ok)


@functools.partial(jax.jit, static_argnames=("model_rate", "unsigned_model"))
def model_update_step(x: jax.Array, model: jax.Array, seq: jax.Array,
                      fell_back: jax.Array, model_rate: int,
                      unsigned_model: bool):
    """Post-pass model transition (reference cmp.c:296-312 + fallback reseed).

    seq==0 (primary pass) seeds the model with the frame; later passes EMA-
    update it; a fallback resets the chain and reseeds.  Per-block.
    """
    updated = preprocess.model_update(
        x, model, jnp.asarray(model_rate, jnp.int32), unsigned_model)
    seeded = jnp.where((seq == 0)[:, None], x, updated)
    return jnp.where(fell_back[:, None], x, seeded)


@functools.partial(jax.jit, static_argnames=("cfg", "fallback_cfg",
                                              "n_words", "ladder",
                                              "cap_bits"))
def encode_blocks_adaptive(cfg: PassConfig, fallback_cfg, x: jax.Array,
                           model: jax.Array, seq: jax.Array,
                           id_hi: jax.Array, id_lo: jax.Array,
                           checksum: jax.Array, n_words: int,
                           ladder: "tuple[int, ...]",
                           cap_bits: "int | None" = None):
    """Adaptive-rate engine pass: per-block Golomb parameter selection.

    Like encode_blocks_device but the Golomb parameter (ZERO or MULTI) is
    chosen per block from the post-preprocessing residual statistics
    (exact rate argmin over a static candidate ladder, ops/adapt.py); the
    chosen parameter and its derived outlier travel in each block's
    header, so the output is ordinary AIRSPACE bitstream.  The optional
    uncompressed fallback composes exactly as in the fixed-rate engine
    (probe criterion cmp.c:362-372, reduced to a size comparison).

    Returns (words, sizes, fell_back (B,) bool, g_selected (B,) int32,
    ok (B,) bool).  ``cap_bits`` marks ``n_words`` as entropy-clamped
    exactly as in the fixed-rate engine (ok=False blocks must re-encode
    at full capacity); without it ok is all-True.
    """
    from . import adapt

    assert cfg.enc_type in (int(EncoderType.GOLOMB_ZERO),
                            int(EncoderType.GOLOMB_MULTI)), \
        "adaptive selection requires a Golomb encoder"
    B, N = x.shape
    residuals = preprocess.preprocess_forward(
        cfg.prep, x, model if cfg.prep == int(Preprocessing.MODEL) else None)
    fast_div = adapt.ladder_fast_div(ladder)
    if cfg.enc_type == int(EncoderType.GOLOMB_ZERO):
        g_sel, _bits = adapt.select_golomb_zero(residuals, ladder)
        hi, lo, lens = adapt.encode_codewords_dynamic(residuals, g_sel,
                                                      fast_div=fast_div)
        # derived outlier for the header (same formulas as the codeword gen)
        g = g_sel.astype(_U32)
        g_log2 = golomb.ilog2(g)
        cutoff = (_U32(2) << g_log2) - g
        opt = cutoff + _U32(16) * g - _U32(1)
        upper = cutoff + (_U32(32) - (g_log2 + _U32(1))) * g
        outlier_dyn = jnp.minimum(opt, upper)
    else:  # GOLOMB_MULTI
        g_sel, outlier_sel, _bits = adapt.select_golomb_multi(
            residuals, cfg.raw_outlier, ladder)
        hi, lo, lens = adapt.encode_codewords_dynamic_multi(
            residuals, g_sel, outlier_sel, fast_div=fast_div)
        outlier_dyn = outlier_sel.astype(_U32)
    worst_bits = adaptive_worst_bits(cfg, ladder)
    words, sizes, ok = _finish_frames(
        cfg, hi, lo, lens, seq, id_hi, id_lo, checksum, n_words, worst_bits,
        enc_param_dyn=g_sel, outlier_dyn=outlier_dyn, cap_bits=cap_bits)
    if fallback_cfg is not None:
        unc_size = 16 + 2 * N + (4 if cfg.checksum else 0)
        fell_back = sizes > unc_size

        def _mk_fb(args):  # see encode_blocks_device: cond skips the
            x_, model_, seq_ = args  # fallback encode when nobody fell
            return _encode_one_pass(
                fallback_cfg, x_, model_, jnp.zeros_like(seq_), id_hi,
                id_lo, checksum, n_words)

        def _mk_none(args):
            return (jnp.zeros((B, n_words), _U32),
                    jnp.zeros((B,), jnp.int32))

        fb_words, fb_sizes = jax.lax.cond(
            jnp.any(fell_back), _mk_fb, _mk_none, (x, model, seq))
        words = jnp.where(fell_back[:, None], fb_words, words)
        sizes = jnp.where(fell_back, fb_sizes, sizes)
        # a fallback block is served by the uncompressed frame: it is ok
        # exactly when that frame fits the (possibly clamped) buffer
        ok = jnp.where(fell_back, unc_size <= n_words * 4, ok)
    else:
        fell_back = jnp.zeros((B,), bool)
    return words, sizes, fell_back, g_sel.astype(jnp.int32), ok


def adaptive_worst_bits(cfg: PassConfig, ladder: "tuple[int, ...]") -> int:
    """Static per-sample worst-case bits across the candidate ladder."""
    if cfg.enc_type == int(EncoderType.GOLOMB_MULTI):
        return 48  # 32-bit escape codeword + 16 raw bits
    return int(max(ladder)).bit_length() - 1 + 17


def adaptive_cap_bits(cfg: PassConfig,
                      ladder: "tuple[int, ...]") -> "int | None":
    """Entropy clamp for the adaptive tier (same policy as
    default_cap_bits: half the common-class worst, floor 8; MULTI
    derives from the ladder's Golomb class, its 48-bit escapes take the
    full-capacity re-encode)."""
    zero_like = int(max(ladder)).bit_length() - 1 + 17
    return max(8, zero_like // 2 - 1)


def adaptive_worst_case_words(cfg: PassConfig, n: int,
                              ladder: "tuple[int, ...]") -> int:
    bits = cfg.hdr_bits + adaptive_worst_bits(cfg, ladder) * n + 7 + 32
    return (bits + 31) // 32 + 1
