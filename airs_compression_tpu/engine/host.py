"""Host (CPU/NumPy) exact codec: the semantic anchor of the framework.

This module is a from-scratch, bit-exact implementation of the AIRSPACE
compression algorithm (and of the decoder the reference never implemented).
It exists for three purposes:

1. **Semantic anchor** — every behavior of the reference C engine
   (lib/compress/cmp.c, encoder.c, preprocess.c, lib/common/
   bitstream_writer.h) is reproduced here in readable Python/NumPy,
   including error taxonomy, capacity/early-break semantics, model-state
   side effects, and the uncompressed-fallback dance.  The device kernels in
   ``airs_compression_tpu.ops`` are validated against this module, and this
   module is validated against the reference C library built from source
   (tests/oracle).
2. **Host fast path** — small CLI inputs are compressed here without paying
   JIT/device-transfer overhead.
3. **Decoder specification** — the reference's CLI prints "Decompression not
   implemented yet" (programs/airspacecli.c:422); the format's decoder is
   defined here (and vectorized on device in ops/decode.py).

Encoding is vectorized with NumPy: per-sample (codeword, bitlength) pairs are
computed in closed form, then concatenated with a logarithmic tree merge of
Python big-ints.  Only the rare capacity-limited path (used by the
uncompressed fallback probe) falls back to an exact scalar bitstream writer,
because the reference's partial-model-update semantics on overflow depend on
64-bit word-flush granularity (bitstream_writer.h:124-158).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..format.dtypes import CmpType, SampleView
from ..format.errors import CmpError, CmpErrorCode
from ..format.header import CMP_CHECKSUM_SIZE, CmpHeader
from ..format.params import (
    CmpParams,
    EncoderType,
    Preprocessing,
    compress_bound,
)
from ..utils.bits import (
    CMP_NUM_BITS_PER_SAMPLE,
    derive_encoder_outlier,
)
from ..utils.xxh32 import cmp_checksum

__all__ = [
    "preprocess_forward",
    "preprocess_inverse",
    "iwt_forward",
    "iwt_inverse",
    "zigzag_map",
    "zigzag_unmap",
    "update_model",
    "golomb_codeword",
    "encode_codewords",
    "pack_codes",
    "compress_pass_host",
    "decode_block",
    "HostBitWriter",
    "BitReader",
]


# --------------------------------------------------------------------------
# Integer helpers (exact C semantics)
# --------------------------------------------------------------------------

def _ilog2_np(x: np.ndarray) -> np.ndarray:
    """Vectorized floor(log2(x)) for x > 0, exact (no floating point)."""
    x = x.astype(np.uint32)
    r = np.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        m = x >= (np.uint32(1) << np.uint32(shift))
        r = np.where(m, r + np.uint32(shift), r)
        x = np.where(m, x >> np.uint32(shift), x)
    return r


def zigzag_map(values_i16: np.ndarray) -> np.ndarray:
    """ZigZag signed->unsigned map for 16-bit samples.

    Mirrors reference map_to_unsigned with n_bits=16 (encoder.c:274-286):
    0->0, -1->1, 1->2, ... INT16_MAX -> 0xFFFE, INT16_MIN -> 0xFFFF.
    Returns uint16.
    """
    v = values_i16.astype(np.int32)
    return (((v << 1) ^ (v >> 15)) & 0xFFFF).astype(np.uint16)


def zigzag_unmap(mapped_u16: np.ndarray) -> np.ndarray:
    """Inverse of zigzag_map; returns int16."""
    m = mapped_u16.astype(np.uint16).astype(np.int32)
    v = (m >> 1) ^ -(m & 1)
    return v.astype(np.int16)


def update_model(data_i16: np.ndarray, model_i16: np.ndarray, model_rate: int,
                 cmp_type: CmpType) -> np.ndarray:
    """EMA model update, exact C semantics (reference cmp.c:120-142).

    For I16/I16_IN_I32 the 16-bit values enter the weighted sum
    sign-extended; for U16 they enter as unsigned.  The weighted sum is
    computed in int32 and arithmetically shifted right by 4
    (CMP_MAX_MODEL_RATE == 16), then truncated to int16.
    """
    if cmp_type is CmpType.U16:
        d = data_i16.view(np.uint16).astype(np.int32)
        m = model_i16.view(np.uint16).astype(np.int32)
    else:
        d = data_i16.astype(np.int32)
        m = model_i16.astype(np.int32)
    w = m * np.int32(model_rate) + d * np.int32(16 - model_rate)
    return (w >> 4).astype(np.int16)


# --------------------------------------------------------------------------
# Preprocessing (forward + inverse), exact int16 wraparound arithmetic
# --------------------------------------------------------------------------

def _floor_div2(x: np.ndarray) -> np.ndarray:
    """Arithmetic >>1 on int32, truncated to int16 (preprocess.c:37-40)."""
    return (x >> 1).astype(np.int16)


def _floor_div4(x: np.ndarray) -> np.ndarray:
    return (x >> 2).astype(np.int16)


def _wrap16(v: np.ndarray) -> np.ndarray:
    """Wrap int32 values to int16 range (C int16_t truncation), stay int32."""
    return (((v & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int32)


def iwt_single_level(x: np.ndarray, s: int) -> np.ndarray:
    """One IWT lifting level at stride ``s`` (reference preprocess.c:140-177).

    Operates on the strided subsequence x[0::s]; positions not on the stride
    pass through unchanged.  In subsequence coordinates j = i/s the
    reference's loop structure reduces to two data-parallel passes:

    * odd j:  y[j] = x[j] - floor((x[j-1] + x[j+1]) / 2)
              (last odd, j == m-1: y[j] = x[j] - x[j-1])
    * even j: y[j] = x[j] + floor((y[j-1] + y[j+1]) / 4)
              (j == 0:  y[0] = x[0] + floor(y[1] / 2);
               last even, j == m-1: y[j] = x[j] + floor(y[j-1] / 2))

    All arithmetic wraps at 16 bits exactly like the C int16_t code.
    """
    n = x.size
    y = x.copy()
    if n == 0 or s >= n:
        return y
    xs = x[::s].astype(np.int32)  # subsequence, sign-extended
    m = xs.size
    ys = np.zeros(m, dtype=np.int32)
    # odd (detail) pass
    odd_j = np.arange(1, m, 2)
    has_right = odd_j + 1 < m
    left = xs[odd_j - 1]
    right = xs[np.minimum(odd_j + 1, m - 1)]
    centre = xs[odd_j]
    ys[odd_j] = _wrap16(np.where(has_right, centre - ((left + right) >> 1),
                                 centre - left))
    # even (approximation) pass, uses odd results
    even_j = np.arange(0, m, 2)
    yl = ys[np.maximum(even_j - 1, 0)]
    yr = ys[np.minimum(even_j + 1, m - 1)]
    centre = xs[even_j]
    mid = centre + ((yl + yr) >> 2)
    first = centre + (yr >> 1)  # j == 0
    last = centre + (yl >> 1)   # j == m-1 (m odd)
    val = np.where(even_j == 0, first, np.where(even_j == m - 1, last, mid))
    ys[even_j] = _wrap16(val)
    y[::s] = ys.astype(np.int16)
    return y


def iwt_forward(samples_i16: np.ndarray) -> np.ndarray:
    """Multi-level IWT decomposition (reference preprocess.c:190-221)."""
    n = samples_i16.size
    out = samples_i16.copy()
    if n <= 1:
        return out
    s = 1
    while s < n:
        out = iwt_single_level(out, s)
        s <<= 1
    return out


def iwt_single_level_inverse(y: np.ndarray, s: int) -> np.ndarray:
    """Inverse of one IWT lifting level at stride ``s`` (new capability).

    Exact inverse of :func:`iwt_single_level`: undo the even (approximation)
    update first — it only depends on stored odd coefficients — then undo
    the odd (detail) predictor using the recovered even samples.  Both
    passes are data-parallel.
    """
    n = y.size
    x = y.copy()
    if n == 0 or s >= n:
        return x
    ys = y[::s].astype(np.int32)
    m = ys.size
    xs = np.zeros(m, dtype=np.int32)
    # even (approximation) pass: x[j] = y[j] - predictor(odd coefficients)
    even_j = np.arange(0, m, 2)
    yl = ys[np.maximum(even_j - 1, 0)]
    yr = ys[np.minimum(even_j + 1, m - 1)]
    centre = ys[even_j]
    mid = centre - ((yl + yr) >> 2)
    first = centre - (yr >> 1)  # j == 0
    last = centre - (yl >> 1)   # j == m-1 (m odd)
    xs[even_j] = _wrap16(np.where(even_j == 0, first,
                                  np.where(even_j == m - 1, last, mid)))
    # odd (detail) pass: x[j] = y[j] + floor((x[j-1] + x[j+1]) / 2)
    odd_j = np.arange(1, m, 2)
    has_right = odd_j + 1 < m
    xl = xs[odd_j - 1]
    xr = xs[np.minimum(odd_j + 1, m - 1)]
    centre = ys[odd_j]
    xs[odd_j] = _wrap16(np.where(has_right, centre + ((xl + xr) >> 1),
                                 centre + xl))
    x[::s] = xs.astype(np.int16)
    return x


def iwt_inverse(coeffs_i16: np.ndarray) -> np.ndarray:
    """Inverse multi-level IWT (new capability; inverts preprocess.c:190-221)."""
    n = coeffs_i16.size
    out = coeffs_i16.copy()
    if n <= 1:
        return out
    strides = []
    s = 1
    while s < n:
        strides.append(s)
        s <<= 1
    for s in reversed(strides):
        out = iwt_single_level_inverse(out, s)
    return out


def preprocess_forward(method: Preprocessing, samples_i16: np.ndarray,
                       model_i16: np.ndarray | None = None) -> np.ndarray:
    """Forward preprocessing -> int16 residuals (reference preprocess.c)."""
    if method == Preprocessing.NONE:
        return samples_i16.copy()
    if method == Preprocessing.DIFF:
        d = samples_i16.astype(np.int32)
        out = d.copy()
        out[1:] = d[1:] - d[:-1]
        return out.astype(np.int16)
    if method == Preprocessing.IWT:
        return iwt_forward(samples_i16)
    if method == Preprocessing.MODEL:
        if model_i16 is None:
            raise CmpError(CmpErrorCode.WORK_BUF_NULL)
        return (samples_i16.astype(np.int32)
                - model_i16.view(np.uint16).astype(np.int32)).astype(np.int16)
    raise CmpError(CmpErrorCode.PARAMS_INVALID, f"unknown preprocessing {method}")


def preprocess_inverse(method: Preprocessing, residuals_i16: np.ndarray,
                       model_i16: np.ndarray | None = None) -> np.ndarray:
    """Inverse preprocessing -> original int16 samples (new capability)."""
    if method == Preprocessing.NONE:
        return residuals_i16.copy()
    if method == Preprocessing.DIFF:
        # diff is wraparound-subtract; inverse = wraparound cumulative sum
        c = np.cumsum(residuals_i16.astype(np.int64))
        return (c & 0xFFFF).astype(np.uint16).view(np.int16)
    if method == Preprocessing.IWT:
        return iwt_inverse(residuals_i16)
    if method == Preprocessing.MODEL:
        if model_i16 is None:
            raise CmpError(CmpErrorCode.WORK_BUF_NULL)
        return (residuals_i16.astype(np.int32)
                + model_i16.view(np.uint16).astype(np.int32)).astype(np.int16)
    raise CmpError(CmpErrorCode.PARAMS_INVALID, f"unknown preprocessing {method}")


# --------------------------------------------------------------------------
# Golomb codeword generation (closed form, vectorized)
# --------------------------------------------------------------------------

def golomb_codeword(values: np.ndarray, g_par: int, g_log2: int):
    """Closed-form Golomb codewords (reference golomb_encode, encoder.c:303-324).

    Returns (codeword: int64, length: int32); caller guarantees every value
    is below golomb_upper_bound so lengths never exceed 32 bits.
    """
    v = values.astype(np.int64)
    cutoff = np.int64((2 << g_log2) - g_par)
    len0 = np.int64(g_log2 + 1)
    in_g0 = v < cutoff
    vg = np.where(in_g0, 0, v - cutoff)
    group = vg // g_par
    rem = vg - group * g_par
    unary = (np.int64(1) << group) - 1
    cw_hi = (unary << (len0 + 1)) + (cutoff << 1) + rem
    cw = np.where(in_g0, v, cw_hi)
    ln = np.where(in_g0, len0, len0 + 1 + group)
    return cw, ln.astype(np.int32)


def encode_codewords(residuals_i16: np.ndarray, encoder_type: EncoderType,
                     g_par: int, outlier: int):
    """Per-sample (codeword, bitlength) for any encoder type.

    Mirrors reference cmp_encoder_encode_s16 (encoder.c:327-378) but
    produces the whole frame at once.  UNCOMPRESSED stores the raw 16-bit
    residual; the Golomb modes store the zigzag-mapped residual.  Codewords
    fit in 48 bits.
    """
    n = residuals_i16.size
    if encoder_type == EncoderType.UNCOMPRESSED:
        raw = residuals_i16.view(np.uint16).astype(np.int64)
        return raw, np.full(n, 16, dtype=np.int32)
    g_log2 = int(np.uint32(g_par).item().bit_length() - 1)
    m = zigzag_map(residuals_i16).astype(np.int64)
    if encoder_type == EncoderType.GOLOMB_ZERO:
        is_esc = m >= outlier
        gv = np.where(is_esc, 0, m + 1)
        cw, ln = golomb_codeword(gv, g_par, g_log2)
        # escape: Golomb(0) == zeros in g_log2+1 bits, then 16 raw bits;
        # combined into one write of the raw value (encoder.c:341-349)
        cw = np.where(is_esc, m, cw)
        ln = np.where(is_esc, g_log2 + 1 + CMP_NUM_BITS_PER_SAMPLE, ln).astype(np.int32)
        return cw, ln
    if encoder_type == EncoderType.GOLOMB_MULTI:
        is_esc = m >= outlier
        diff = np.where(is_esc, m - outlier, 0)
        level = np.where(diff < 4, 0, _ilog2_np(diff.astype(np.uint32)).astype(np.int64) // 2)
        gv = np.where(is_esc, outlier + level, m)
        cw, ln = golomb_codeword(gv, g_par, g_log2)
        raw_bits = ((level + 1) * 2).astype(np.int64)
        cw = np.where(is_esc, (cw << raw_bits) | diff, cw)
        ln = np.where(is_esc, ln + raw_bits, ln).astype(np.int32)
        return cw, ln
    raise CmpError(CmpErrorCode.PARAMS_INVALID, f"unknown encoder {encoder_type}")


def pack_codes(codes: np.ndarray, lens: np.ndarray, prefix: bytes = b"") -> bytes:
    """Concatenate MSB-first variable-length codes after ``prefix`` bytes.

    Logarithmic tree merge over Python big-ints: O(total_bits * log n).
    """
    items = [(int(c), int(l)) for c, l in zip(codes.tolist(), lens.tolist())]
    if not items:
        total, bits = 0, 0
    else:
        while len(items) > 1:
            nxt = []
            for i in range(0, len(items) - 1, 2):
                (a, la), (b, lb) = items[i], items[i + 1]
                nxt.append(((a << lb) | b, la + lb))
            if len(items) % 2:
                nxt.append(items[-1])
            items = nxt
        total, bits = items[0]
    nbytes = (bits + 7) // 8
    total <<= nbytes * 8 - bits  # pad last byte with zeros
    return prefix + total.to_bytes(nbytes, "big")


# --------------------------------------------------------------------------
# Exact bitstream writer (only used on the capacity-limited path)
# --------------------------------------------------------------------------

class HostBitWriter:
    """Bit-exact mirror of the reference bitstream writer
    (lib/common/bitstream_writer.h:38-264): 64-bit cache, 8-byte aligned
    word flushes, sticky error, identical capacity failure points."""

    def __init__(self, capacity: int):
        self.buf = bytearray(capacity)
        self.capacity = capacity
        self.cache = 0
        self.bit_cap = 64
        self.pos = 0  # bytes flushed (ptr - start)
        self.error = CmpErrorCode.NO_ERROR

    def add_bits32(self, value: int, nb_bits: int) -> None:
        if self.error != CmpErrorCode.NO_ERROR:
            return
        if nb_bits > 32 or (nb_bits < 32 and (value >> nb_bits)):
            self.error = CmpErrorCode.INT_BITSTREAM
            return
        if nb_bits < self.bit_cap:
            self.cache = ((self.cache << nb_bits) | value) & 0xFFFFFFFFFFFFFFFF
            self.bit_cap -= nb_bits
            return
        if self.capacity - self.pos >= 8:
            cache = ((self.cache << self.bit_cap) & 0xFFFFFFFFFFFFFFFF) | (
                value >> (nb_bits - self.bit_cap)
            )
            self.buf[self.pos : self.pos + 8] = cache.to_bytes(8, "big")
            self.pos += 8
            self.cache = value
            self.bit_cap += 64 - nb_bits
        else:
            self.error = CmpErrorCode.DST_TOO_SMALL

    def add_bits64(self, value: int, nb_bits: int) -> None:
        if nb_bits <= 32:
            self.add_bits32(value & 0xFFFFFFFF, nb_bits)
        else:
            self.add_bits32((value >> 32) & 0xFFFFFFFF, nb_bits - 32)
            self.add_bits32(value & 0xFFFFFFFF, 32)

    def pad_last_byte(self) -> None:
        bits_in_last_byte = (64 - self.bit_cap) % 8
        if bits_in_last_byte:
            self.add_bits32(0, 8 - bits_in_last_byte)

    def flush(self) -> int:
        if self.error != CmpErrorCode.NO_ERROR:
            raise CmpError(self.error)
        cursor = self.pos
        nbytes = (64 - self.bit_cap + 7) // 8
        if nbytes:
            tmp = (self.cache << self.bit_cap) & 0xFFFFFFFFFFFFFFFF
            for _ in range(nbytes):
                if cursor >= self.capacity:
                    self.error = CmpErrorCode.DST_TOO_SMALL
                    raise CmpError(self.error)
                self.buf[cursor] = (tmp >> 56) & 0xFF
                cursor += 1
                tmp = (tmp << 8) & 0xFFFFFFFFFFFFFFFF
        return cursor


# --------------------------------------------------------------------------
# One compression pass (the reference compress_engine, vectorized)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PassResult:
    """Outcome of one engine pass over one frame."""
    compressed: bytes | None  # None on error
    error: CmpErrorCode
    model_updated: int  # number of model entries touched (C parity)


def _header_for_pass(params: CmpParams, secondary: bool, packed_size: int,
                     identifier: int, sequence_number: int, outlier: int) -> CmpHeader:
    prep, enc_t, enc_p, _ = params.pass_params(secondary)
    hdr = CmpHeader(
        version_flag=1,
        compressed_size=0,
        original_size=packed_size,
        identifier=identifier,
        sequence_number=sequence_number,
        preprocessing=int(prep),
        checksum_enabled=1 if params.checksum_enabled else 0,
        encoder_type=int(enc_t),
    )
    if prep == Preprocessing.MODEL:
        hdr.model_rate = params.model_rate
    if enc_t != EncoderType.UNCOMPRESSED:
        hdr.encoder_param = enc_p
        hdr.encoder_outlier = outlier
    return hdr


def compress_pass_host(params: CmpParams, secondary: bool, view: SampleView,
                       model_i16: np.ndarray | None, sequence_number: int,
                       identifier: int, dst_capacity: int) -> PassResult:
    """One engine pass: preprocess -> encode -> frame (reference cmp.c:213-338).

    Does NOT implement pass selection/reset/fallback — that orchestration
    lives in engine/context.py.  ``model_i16`` is mutated exactly like the
    reference work buffer (seeded on sequence 0, EMA-updated afterwards,
    partially updated if the destination overflows mid-frame).
    """
    prep, enc_t, enc_p, out_p = params.pass_params(secondary)
    outlier = derive_encoder_outlier(int(enc_t), enc_p, out_p)
    packed_size = view.packed_size

    hdr = _header_for_pass(params, secondary, packed_size, identifier, sequence_number, outlier)
    hdr_size = hdr.size

    model_needed = params.model_is_needed()
    samples = view.samples_i16
    residuals = preprocess_forward(prep, samples,
                                   model_i16 if prep == Preprocessing.MODEL else None)
    codes, lens = encode_codewords(residuals, enc_t, enc_p, outlier)

    total_bits = int(lens.sum())
    payload_bytes = (total_bits + 7) // 8
    csum_bytes = CMP_CHECKSUM_SIZE if params.checksum_enabled else 0
    compressed_size = hdr_size + payload_bytes + csum_bytes

    try:
        bound = compress_bound(packed_size)
    except CmpError:
        bound = (1 << 32) - 1

    def _update_model_full(n_ok: int) -> int:
        if not model_needed or model_i16 is None:
            return 0
        if sequence_number == 0:
            model_i16[:n_ok] = samples[:n_ok]
        else:
            model_i16[:n_ok] = update_model(samples[:n_ok], model_i16[:n_ok],
                                            params.model_rate, view.type)
        return n_ok

    if compressed_size <= dst_capacity:
        # Fast path: cannot overflow (flushes are monotone in written bytes)
        hdr.compressed_size = compressed_size
        from .. import native

        if native.native_available():
            frame = bytearray(compressed_size)
            frame[:hdr_size] = hdr.serialize()
            end_bit = native.encode_residuals(
                residuals, int(enc_t), enc_p, outlier, frame, hdr_size * 8)
            assert end_bit == hdr_size * 8 + total_bits
        else:
            frame = bytearray(hdr.serialize())
            frame += pack_codes(codes, lens)
            frame += b"\x00" * (compressed_size - len(frame) - csum_bytes)
        if params.checksum_enabled:
            frame[compressed_size - 4:compressed_size] = \
                cmp_checksum(view.samples_u16).to_bytes(4, "big")
        n_upd = _update_model_full(view.num_samples)
        return PassResult(bytes(frame), CmpErrorCode.NO_ERROR, n_upd)

    # Capacity-limited path: replicate the reference's exact failure point
    # and partial model updates (cmp.c:296-312 + bitstream_writer.h:124-158).
    bw = HostBitWriter(dst_capacity)
    hdr.compressed_size = 0
    _serialize_header_bits(bw, hdr)
    n_upd = 0
    check_early = dst_capacity < bound
    for i in range(view.num_samples):
        _encode_one(bw, enc_t, int(residuals[i]), enc_p, outlier)
        if check_early and bw.error != CmpErrorCode.NO_ERROR:
            break
        if model_needed and model_i16 is not None:
            if sequence_number == 0:
                model_i16[i] = samples[i]
            else:
                model_i16[i : i + 1] = update_model(samples[i : i + 1],
                                                    model_i16[i : i + 1],
                                                    params.model_rate, view.type)
            n_upd = i + 1
    if params.checksum_enabled:
        bw.pad_last_byte()
        bw.add_bits32(cmp_checksum(view.samples_u16), 32)
    try:
        size = bw.flush()
    except CmpError as e:
        return PassResult(None, e.code, n_upd)
    # rewind + rewrite header with final size (cmp.c:329-334)
    hdr.compressed_size = size
    bw.buf[: hdr_size] = hdr.serialize()
    return PassResult(bytes(bw.buf[:size]), CmpErrorCode.NO_ERROR, n_upd)


def _serialize_header_bits(bw: HostBitWriter, hdr: CmpHeader) -> None:
    """Header via the bit writer (reference cmp_hdr_serialize, header.c:24-67)."""
    bw.add_bits64(hdr.version_flag, 1)
    bw.add_bits64(hdr.version_id, 15)
    bw.add_bits64(hdr.compressed_size, 24)
    bw.add_bits64(hdr.original_size, 24)
    bw.add_bits64(hdr.identifier, 48)
    bw.add_bits64(hdr.sequence_number, 8)
    bw.add_bits64(hdr.preprocessing, 4)
    bw.add_bits64(hdr.checksum_enabled, 1)
    bw.add_bits64(hdr.encoder_type, 3)
    if hdr.has_extension:
        bw.add_bits64(hdr.model_rate, 8)
        bw.add_bits64(hdr.encoder_param, 16)
        bw.add_bits64(hdr.encoder_outlier, 24)


def _encode_one(bw: HostBitWriter, enc_t: EncoderType, residual: int,
                g_par: int, outlier: int) -> None:
    """Scalar encode of one residual sample (reference encoder.c:327-378)."""
    if enc_t == EncoderType.UNCOMPRESSED:
        bw.add_bits32(residual & 0xFFFF, 16)
        return
    mapped = ((residual << 1) ^ (residual >> 15)) & 0xFFFF
    g_log2 = g_par.bit_length() - 1
    if enc_t == EncoderType.GOLOMB_ZERO:
        if mapped < outlier:
            _golomb_one(bw, mapped + 1, g_par, g_log2)
        else:
            bw.add_bits32(mapped, g_log2 + 1 + 16)
    else:  # GOLOMB_MULTI
        if mapped < outlier:
            _golomb_one(bw, mapped, g_par, g_log2)
        else:
            diff = mapped - outlier
            level = 0 if diff < 4 else (diff.bit_length() - 1) // 2
            _golomb_one(bw, outlier + level, g_par, g_log2)
            bw.add_bits32(diff, (level + 1) * 2)


def _golomb_one(bw: HostBitWriter, value: int, g_par: int, g_log2: int) -> None:
    cutoff = (2 << g_log2) - g_par
    if value < cutoff:
        bw.add_bits32(value, g_log2 + 1)
    else:
        group = (value - cutoff) // g_par
        rem = (value - cutoff) - group * g_par
        unary = (1 << group) - 1
        ln = g_log2 + 1
        cw = (unary << (ln + 1)) + (cutoff << 1) + rem
        bw.add_bits32(cw, ln + 1 + group)


# --------------------------------------------------------------------------
# Decoder (new capability — the reference never implemented decompression)
# --------------------------------------------------------------------------

class BitReader:
    """MSB-first big-endian bit reader over a bytes payload."""

    def __init__(self, data: bytes, bit_offset: int = 0):
        self.data = data
        self.pos = bit_offset
        self.nbits = len(data) * 8

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise CmpError(CmpErrorCode.INT_BITSTREAM, "bitstream exhausted")
        v = 0
        pos = self.pos
        remaining = n
        while remaining:
            byte = self.data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, remaining)
            shift = avail - take
            v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            remaining -= take
        self.pos = pos
        return v

    def count_leading_ones(self, limit: int = 48) -> int:
        c = 0
        while c < limit and self.read(1) == 1:
            c += 1
        return c

    def align_to_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _golomb_decode_one(br: BitReader, g_par: int, g_log2: int) -> int:
    """Standard Golomb decode: unary quotient + truncated-binary remainder.

    Inverse of reference golomb_encode (encoder.c:303-324); the reference's
    cutoff/group formulation is algebraically the classical Golomb code.
    """
    cutoff = (2 << g_log2) - g_par
    q = 0
    while br.read(1) == 1:
        q += 1
        if q > 32:
            raise CmpError(CmpErrorCode.INT_BITSTREAM, "unary prefix too long")
    r = br.read(g_log2) if g_log2 else 0
    if r >= cutoff:
        r = ((r << 1) | br.read(1)) - cutoff
    return q * g_par + r


def decode_block(frame: bytes, model_i16: np.ndarray | None = None,
                 verify_checksum: bool = True):
    """Decode one AIRSPACE block -> (samples_u16, header, total_size).

    ``model_i16`` must be the reconstructed model state when the block uses
    MODEL preprocessing (sequence_number > 0 in a chain).  Returns the
    decoded samples as uint16 (the packed representation; the format does
    not record the source dtype), the parsed header, and the block's total
    size in the input buffer (= header.compressed_size).
    """
    hdr, hdr_size = CmpHeader.deserialize(frame)
    if hdr.compressed_size < hdr_size or hdr.compressed_size > len(frame):
        raise CmpError(CmpErrorCode.INT_HDR, "compressed_size inconsistent")
    n_samples = hdr.original_size // 2
    if hdr.original_size % 2:
        raise CmpError(CmpErrorCode.INT_HDR, "odd original_size")
    block = frame[: hdr.compressed_size]
    try:
        enc_t = EncoderType(hdr.encoder_type)
        prep = Preprocessing(hdr.preprocessing)
    except ValueError:
        # corrupt method byte (values outside the enums) must surface as
        # a format error, not a raw ValueError (found by differential fuzz)
        raise CmpError(CmpErrorCode.INT_HDR,
                       f"unknown method {hdr.preprocessing}/{hdr.encoder_type}")

    if enc_t != EncoderType.UNCOMPRESSED and not (1 <= hdr.encoder_param <= 0xFFFF):
        raise CmpError(CmpErrorCode.PARAMS_INVALID, "bad Golomb parameter in header")

    from .. import native

    if native.native_available():
        vals, end_bit = native.decode_mapped(
            bytes(block), hdr_size * 8, n_samples, int(enc_t),
            hdr.encoder_param, hdr.encoder_outlier)
        if vals is None:
            raise CmpError(CmpErrorCode.INT_BITSTREAM, "malformed payload")
        br = BitReader(block, end_bit)
        if enc_t == EncoderType.UNCOMPRESSED:
            residuals = vals.view(np.int16)
        else:
            residuals = zigzag_unmap(vals)
    else:
        br = BitReader(block, hdr_size * 8)
        if enc_t == EncoderType.UNCOMPRESSED:
            # raw 16-bit residuals, no zigzag map (encoder.c:331-333)
            raw = np.fromiter((br.read(16) for _ in range(n_samples)),
                              dtype=np.uint16, count=n_samples)
            residuals = raw.view(np.int16)
        else:
            g_par = hdr.encoder_param
            g_log2 = g_par.bit_length() - 1
            outlier = hdr.encoder_outlier
            out = np.empty(n_samples, dtype=np.uint16)
            if enc_t == EncoderType.GOLOMB_ZERO:
                for i in range(n_samples):
                    p0 = br.pos
                    v = _golomb_decode_one(br, g_par, g_log2)
                    if br.pos - p0 > 32:
                        # no conforming encoder emits a Golomb part wider
                        # than the 32-bit codeword cap (encoder.h:17-30)
                        raise CmpError(CmpErrorCode.INT_BITSTREAM,
                                       "malformed payload")
                    if v == 0:  # escape: raw 16-bit mapped value follows
                        out[i] = br.read(16)
                    else:
                        if v - 1 > 0xFFFF:  # non-emittable mapped value
                            raise CmpError(CmpErrorCode.INT_BITSTREAM,
                                           "malformed payload")
                        out[i] = v - 1
            else:  # GOLOMB_MULTI
                for i in range(n_samples):
                    p0 = br.pos
                    v = _golomb_decode_one(br, g_par, g_log2)
                    if br.pos - p0 > 32:
                        raise CmpError(CmpErrorCode.INT_BITSTREAM,
                                       "malformed payload")
                    if v >= outlier:
                        level = v - outlier
                        nb = (level + 1) * 2
                        if nb > 32:  # escape wider than any encoder emits
                            raise CmpError(CmpErrorCode.INT_BITSTREAM,
                                           "malformed payload")
                        diff = br.read(nb)
                        val = outlier + diff
                        if val > 0xFFFF:  # non-emittable mapped value
                            raise CmpError(CmpErrorCode.INT_BITSTREAM,
                                           "malformed payload")
                        out[i] = val
                    else:
                        if v > 0xFFFF:
                            raise CmpError(CmpErrorCode.INT_BITSTREAM,
                                           "malformed payload")
                        out[i] = v
            residuals = zigzag_unmap(out)

    samples = preprocess_inverse(prep, residuals,
                                 model_i16 if prep == Preprocessing.MODEL else None)

    if hdr.checksum_enabled:
        br.align_to_byte()
        stored = br.read(32)
        if verify_checksum:
            calc = cmp_checksum(samples.view(np.uint16))
            if calc != stored:
                raise CmpError(CmpErrorCode.GENERIC,
                               f"checksum mismatch: stored {stored:#010x} != computed {calc:#010x}")
    # all payload bits consumed must fit in compressed_size
    if (br.pos + 7) // 8 > hdr.compressed_size:
        raise CmpError(CmpErrorCode.INT_BITSTREAM, "payload exceeds compressed_size")
    return samples.view(np.uint16), hdr, hdr.compressed_size
