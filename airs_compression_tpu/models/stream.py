"""Batched stream compressor: the flagship device pipeline.

Drives the on-device encoder (ops/encode.py) over B independent block
chains in lockstep: one call compresses one frame per chain, advancing
every chain's pass state (sequence number, identifier, model) with the
exact semantics of B independent reference contexts processed in block
order (reference cmp.c:213-393).

Host responsibilities (everything the device cannot or should not do):
  * identifier draws from the process timestamp source, in block order,
    including the double-draw on an uncompressed fallback (cmp.c:380-392 +
    engine re-reset) — fallen-back frames get their header identifier
    bytes patched after the device call;
  * slicing the device's fixed-capacity word buffers into per-frame bytes.

XXH32 checksums are computed batch-parallel ON DEVICE on the GPU
(ops/xxh32_device.py) on both the encode and the verify side; elsewhere
the host implementation computes them (ops/routing.checksum_path).

Mixed-phase batches (some chains on a primary pass, others on secondary —
possible after a fallback resets one chain) are handled by encoding the
batch under both pass configs and selecting per block.
"""

from __future__ import annotations

import dataclasses as _dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..engine import context as _context
from ..format.dtypes import CmpType
from ..format.errors import CmpError, CmpErrorCode
from ..format.params import CmpParams, Preprocessing
from ..ops.encode import (
    encode_blocks_device,
    make_pass_config,
    model_update_step,
    worst_case_words,
)
from ..utils.xxh32 import cmp_checksum

__all__ = ["BatchCompressor", "BatchDecompressor", "StagedFrames",
           "DecodedFrames"]


class BatchCompressor:
    """Compress sequences of (B, N) u16 frames on device, AIRSPACE-exact."""

    def __init__(self, params: CmpParams, batch: int, n_samples: int,
                 cmp_type: CmpType = CmpType.U16, adaptive: bool = False,
                 ladder: "tuple[int, ...] | None" = None):
        params.validate()
        if 2 * n_samples > (1 << 24) - 1:
            raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
        self.params = params
        self.batch = batch
        self.n_samples = n_samples
        self.cmp_type = cmp_type
        self.adaptive = adaptive
        if adaptive:
            from ..ops.adapt import DEFAULT_LADDER
            from ..ops.encode import adaptive_cap_bits

            self.ladder = tuple(ladder) if ladder else DEFAULT_LADDER
            self._adaptive_cap = adaptive_cap_bits(
                make_pass_config(params, False, cmp_type is CmpType.U16),
                self.ladder)
        else:
            self.ladder = None
            self._adaptive_cap = None
        unsigned = cmp_type is CmpType.U16
        self.primary_cfg = make_pass_config(params, False, unsigned)
        self.secondary_cfg = (make_pass_config(params, True, unsigned)
                              if params.secondary_iterations else None)
        self.fallback_cfg = None
        if params.uncompressed_fallback_enabled:
            import dataclasses as _dc

            fb_params = _dc.replace(params, primary_preprocessing=Preprocessing.NONE,
                                    primary_encoder_type=0)
            self.fallback_cfg = make_pass_config(fb_params, False, unsigned)
        caps = [worst_case_words(self.primary_cfg, n_samples)]
        if self.secondary_cfg:
            caps.append(worst_case_words(self.secondary_cfg, n_samples))
        if self.adaptive:
            from ..ops.encode import adaptive_worst_case_words

            for c in (self.primary_cfg, self.secondary_cfg):
                if c is not None and c.enc_type in (1, 2):
                    caps.append(adaptive_worst_case_words(c, n_samples,
                                                          self.ladder))
        self.n_words = max(caps)
        # entropy-clamped frame buffers (ops/encode.clamped_frame_words):
        # per-config cap, dropped to None (sticky) if this stream's data
        # overflows it
        from ..ops.encode import default_cap_bits

        self._cap_bits = {
            c: default_cap_bits(c)
            for c in (self.primary_cfg, self.secondary_cfg) if c is not None}
        # per-chain state (host side mirrors of reference cmp_context)
        self.seq = np.zeros(batch, dtype=np.int64)
        self.identifiers = np.zeros(batch, dtype=np.int64)
        self.model = jnp.zeros((batch, n_samples), jnp.int32)
        self._started = np.zeros(batch, dtype=bool)
        from ..utils.profiling import ThroughputMeter

        self.metrics = ThroughputMeter()

    # -- identifier bookkeeping (block order, like sequential C contexts) --
    def _draw_ids(self, mask: np.ndarray, draws_per_block: int = 1) -> None:
        idxs = np.nonzero(mask)[0]
        if idxs.size == 0:
            return
        # one bulk draw (block order preserved; with multiple draws per
        # block — the fallback's double draw — the LAST draw is kept,
        # exactly like the sequential per-block loop did)
        ids = _context._new_identifiers(idxs.size * draws_per_block)
        self.identifiers[idxs] = ids[draws_per_block - 1::draws_per_block] \
            .astype(np.int64)

    def reset(self) -> None:
        """Reset every chain (reference cmp_reset semantics per block)."""
        self.seq[:] = 0
        self._draw_ids(np.ones(self.batch, dtype=bool))
        self._started[:] = False

    def _clamped_words(self, cfg, cap: int) -> int:
        """Frame buffer width under the entropy clamp ``cap``."""
        from ..ops.encode import adaptive_worst_bits, clamped_payload_words

        wb = (adaptive_worst_bits(cfg, self.ladder) if self.adaptive
              else cfg.worst_bits_per_sample)
        words = ((cfg.hdr_bits + 31) // 32
                 + clamped_payload_words(wb, cap, self.n_samples) + 3)
        if self.fallback_cfg is not None:
            # an uncompressed fallback frame is a legitimate output of
            # known size: it must fit without a re-encode
            unc_bytes = 16 + 2 * self.n_samples + 4 * bool(cfg.checksum)
            words = max(words, (unc_bytes + 3) // 4)
        return min(words, self.n_words)

    # -- main entry ------------------------------------------------------
    def _encode_frames(self, frames):
        """Device-encode one (B, N) frame per chain.

        The shared core of :meth:`compress_frames` /
        :meth:`compress_frames_packed`: runs the device passes, advances
        the chain state and draws the fallback identifier replacements.
        Returns ``(words_dev, sizes_dev, sizes_np, fell_np)`` — the
        device word matrix stays un-swapped and un-fetched so each
        wrapper picks its own extraction (matrix fetch for the bytes
        list; on-device stream merge for the packed form); fallback rows
        still carry the pre-reset identifier — extraction patches bytes
        8:14 from ``self.identifiers``.
        """
        if self.cmp_type is CmpType.I16_IN_I32:
            arr = np.asarray(frames)
            if arr.dtype.itemsize != 4:
                raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                               "I16_IN_I32 input must be 32-bit words")
            x_np = np.ascontiguousarray(
                (arr & 0xFFFF).astype(np.uint16))
        else:
            x_np = np.ascontiguousarray(np.asarray(frames).astype(np.uint16))
        if x_np.shape != (self.batch, self.n_samples):
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"expected {(self.batch, self.n_samples)}, got {x_np.shape}")

        # pass selection per chain (cmp.c:228-248)
        primary_mask = (self.seq == 0) | (self.seq > self.params.secondary_iterations)
        # chains entering a primary pass reset: seq->0, fresh identifier
        self.seq[primary_mask] = 0
        self._draw_ids(primary_mask)

        x = jnp.asarray(x_np.view(np.int16), jnp.int32)
        seq_dev = jnp.asarray(self.seq.astype(np.int32))
        id_hi = jnp.asarray(((self.identifiers >> 24) & 0xFFFFFF).astype(np.uint32))
        id_lo = jnp.asarray((self.identifiers & 0xFFFFFF).astype(np.uint32))

        if self.params.checksum_enabled:
            from ..ops.xxh32_device import (
                checksum_blocks_device,
                use_device_checksum,
            )

            if use_device_checksum(self.n_samples):
                # batch-parallel on device; the result feeds the encoder
                # without ever visiting the host (was: a sequential host
                # loop in the middle of the device pipeline)
                checksum = checksum_blocks_device(x)
            else:
                csums = np.fromiter(
                    (cmp_checksum(row) for row in x_np), dtype=np.uint32,
                    count=self.batch)
                checksum = jnp.asarray(csums)
        else:
            checksum = jnp.zeros((self.batch,), jnp.uint32)

        all_primary = bool(primary_mask.all())
        all_secondary = bool((~primary_mask).all())

        def run(cfg):
            if self.adaptive and cfg.enc_type in (1, 2):  # ZERO or MULTI
                from ..ops.encode import encode_blocks_adaptive

                cap = self._adaptive_cap
                if cap is not None:
                    w, s, fb, _g, ok = encode_blocks_adaptive(
                        cfg, self.fallback_cfg, x, self.model, seq_dev,
                        id_hi, id_lo, checksum,
                        self._clamped_words(cfg, cap), self.ladder,
                        cap_bits=cap)
                    if bool(np.asarray(jnp.all(ok))):
                        return w, s, fb
                    # sticky, like the fixed-rate path below
                    self._adaptive_cap = None
                w, s, fb, _g, _ok = encode_blocks_adaptive(
                    cfg, self.fallback_cfg, x, self.model, seq_dev, id_hi,
                    id_lo, checksum, self.n_words, self.ladder)
                return w, s, fb
            cap = self._cap_bits.get(cfg)
            if cap is not None:
                w, s, fb, ok = encode_blocks_device(
                    cfg, self.fallback_cfg, x, self.model, seq_dev, id_hi,
                    id_lo, checksum, self._clamped_words(cfg, cap),
                    cap_bits=cap)
                if bool(np.asarray(jnp.all(ok))):
                    return w, s, fb
                # entropy clamp overflowed for this data: re-encode at full
                # capacity and stop clamping this config (sticky — data
                # that overflowed once tends to keep doing it)
                self._cap_bits[cfg] = None
            return encode_blocks_device(cfg, self.fallback_cfg, x, self.model,
                                        seq_dev, id_hi, id_lo, checksum,
                                        self.n_words)

        if all_primary or self.secondary_cfg is None:
            words, sizes, fell_back = run(self.primary_cfg)
        elif all_secondary:
            words, sizes, fell_back = run(self.secondary_cfg)
        else:
            w_p, s_p, f_p = run(self.primary_cfg)
            w_s, s_s, f_s = run(self.secondary_cfg)
            nw = max(w_p.shape[1], w_s.shape[1])
            pad = lambda w: jnp.pad(w, ((0, 0), (0, nw - w.shape[1])))
            pm = jnp.asarray(primary_mask)
            words = jnp.where(pm[:, None], pad(w_p), pad(w_s))
            sizes = jnp.where(pm, s_p, s_s)
            fell_back = jnp.where(pm, f_p, f_s)

        # model transition (only meaningful when the chain keeps a model)
        if self.params.model_is_needed():
            self.model = model_update_step(
                x, self.model, seq_dev, fell_back,
                self.params.model_rate,
                self.cmp_type is CmpType.U16)

        import sys as _sys

        sizes_np = np.asarray(sizes)
        fell_np = np.asarray(fell_back)

        # sequence transitions: normal pass -> seq+1; fallback -> chain was
        # reset and the uncompressed pass ran at seq 0 -> next seq is 1
        self.seq = np.where(fell_np, 1, self.seq + 1)
        # the reference draws two fresh identifiers on fallback (generic
        # reset + engine reset, cmp.c:380-392), keeping the second; the
        # frame extraction patches the header identifier bytes
        fb = np.nonzero(fell_np)[0]
        if fb.size:
            ids = _context._new_identifiers(2 * fb.size)[1::2]
            self.identifiers[fb] = ids.astype(np.int64)
        return words, sizes, sizes_np, fell_np

    def compress_frames(self, frames) -> "list[bytes]":
        """Compress one (B, N) frame per chain; returns B AIRSPACE frames.

        Input dtype follows the constructor's ``cmp_type`` (reference
        sample_reader.h:9-78): U16/I16 take (B, N) 16-bit samples;
        I16_IN_I32 takes (B, N) int32 words whose low 16 bits are the
        samples (upper halves ignored; ``original_size`` stays 2N — the
        *packed* size, sample_reader.h:75-78).

        Callers writing the frames to one stream/file should prefer
        :meth:`compress_frames_packed` (no per-frame bytes objects).
        """
        import sys as _sys
        import time as _time

        _t0 = _time.perf_counter()
        words, _sizes, sizes_np, fell_np = self._encode_frames(frames)
        if _sys.byteorder == "little":
            words = bswap32(words)  # device-side: rows fetch as BE bytes
        # some backends hand back non-C-contiguous views; the u8 row
        # view below requires contiguity (no-op copy otherwise)
        rows = np.ascontiguousarray(np.asarray(words)) \
            .view(np.uint8).reshape(self.batch, -1)
        stride = rows.shape[1]
        rb = rows.tobytes()
        frames_out: "list[bytes]" = []
        for b in range(self.batch):
            frame = rb[b * stride: b * stride + int(sizes_np[b])]
            if fell_np[b]:
                patched = bytearray(frame)
                patched[8:14] = int(self.identifiers[b]).to_bytes(6, "big")
                frame = bytes(patched)
            frames_out.append(frame)
        self.metrics.record(2 * self.batch * self.n_samples,
                            sum(map(len, frames_out)),
                            _time.perf_counter() - _t0)
        return frames_out

    def compress_frames_packed(self, frames, as_array: bool = False,
                               assemble: str = "auto"):
        """Compress one (B, N) frame per chain into ONE packed stream.

        Returns ``(stream, sizes)``: the B frames concatenated in block
        order (the AIRSPACE stream/file layout, reference
        programs/file.c:435-488) and their per-frame byte sizes.
        ``as_array=True`` returns the stream as a uint8 numpy array —
        no final bytes copy — for callers that write to a file/socket.

        ``assemble`` picks where the frames concatenate:

        * ``"auto"`` (default): the platform's choice
          (ops/routing.assemble_path).
        * ``"host"``: fetch the byte-swapped frame matrix and run one
          native C row gather — a host memcpy of the compressed bytes,
          overlappable with the next batch's device encode.
        * ``"device"``: merge the frame word streams through log2(B)
          funnel-shift levels on device (ops/bitpack.merge_streams_tree)
          and fetch only the trimmed stream.
        """
        import sys as _sys
        import time as _time

        _t0 = _time.perf_counter()
        words, sizes_dev, sizes_np, fell_np = self._encode_frames(frames)
        little = _sys.byteorder == "little"
        total = int(sizes_np.sum())
        if assemble == "auto":
            from ..ops import routing

            assemble = routing.assemble_path(routing.platform())
        if assemble == "device":
            stream = _pack_stream_device(words, sizes_dev, little)
            arr = np.ascontiguousarray(
                np.asarray(stream[: (total + 3) // 4])) \
                .view(np.uint8)[:total]
        elif assemble == "host":
            if little:
                words = bswap32(words)
            rows = np.ascontiguousarray(np.asarray(words)) \
                .view(np.uint8).reshape(self.batch, -1)
            from .. import native

            if native.native_available():
                arr = np.frombuffer(
                    native.gather_rows(rows, sizes_np, rows.shape[1]),
                    np.uint8)
            else:
                arr = np.concatenate(
                    [rows[b, : sizes_np[b]] for b in range(self.batch)])
        else:
            raise ValueError(f"unknown assemble mode {assemble!r}")
        fb = np.nonzero(fell_np)[0]
        if fb.size:
            if not arr.flags.writeable:
                arr = arr.copy()
            offs = np.concatenate(([0], np.cumsum(sizes_np)[:-1]))
            for b in fb:
                arr[offs[b] + 8: offs[b] + 14] = np.frombuffer(
                    int(self.identifiers[b]).to_bytes(6, "big"), np.uint8)
        out = arr if as_array else arr.tobytes()
        self.metrics.record(2 * self.batch * self.n_samples, total,
                            _time.perf_counter() - _t0)
        return out, sizes_np


@functools.partial(jax.jit, static_argnames=("swap",))
def _pack_stream_device(words: jax.Array, sizes: jax.Array,
                        swap: bool) -> jax.Array:
    """Merge B frame word streams into ONE packed stream on device.

    Frames are byte-aligned left-justified bit streams (bits =
    sizes * 8), so their in-order concatenation through the funnel-shift
    merge tree IS the AIRSPACE stream/file layout; the byte swap fuses
    into the same graph.  Returns the (B * n_words,) uint32 stream
    (valid through sum(sizes) bytes).
    """
    from ..ops.bitpack import merge_streams_tree

    B = words.shape[0]
    M = 1 << max((B - 1).bit_length(), 0)
    bits = sizes.astype(jnp.int32) * 8
    if M != B:  # pad the stream count to a power of two with empty rows
        words = jnp.concatenate(
            [words, jnp.zeros((M - B, words.shape[1]), jnp.uint32)])
        bits = jnp.concatenate([bits, jnp.zeros((M - B,), jnp.int32)])
    stream, _total = merge_streams_tree(words, bits)
    return _bswap32_expr(stream) if swap else stream


def _bswap32_expr(w: jax.Array) -> jax.Array:
    w = w.astype(jnp.uint32)
    return ((w << jnp.uint32(24))
            | ((w & jnp.uint32(0xFF00)) << jnp.uint32(8))
            | ((w >> jnp.uint32(8)) & jnp.uint32(0xFF00))
            | (w >> jnp.uint32(24)))


@jax.jit
def bswap32(w: jax.Array) -> jax.Array:
    """Byte-swap uint32 words (one fused elementwise pass on device)."""
    return _bswap32_expr(w)


def _stack_words_expr(ws, raws: "tuple[bool, ...]", nw: int):
    out = []
    for w, r in zip(ws, raws):
        if r:
            w = _bswap32_expr(w)
        if w.shape[1] < nw:
            w = jnp.pad(w, ((0, 0), (0, nw - w.shape[1])))
        out.append(w)
    return jnp.concatenate(out, axis=0)


@functools.partial(jax.jit, static_argnames=("raws", "nw"))
def _stack_words(ws, raws: "tuple[bool, ...]", nw: int):
    """Swap/pad/concatenate several batches' word matrices in ONE
    dispatch (the coalesced launch's staging-side device work)."""
    return _stack_words_expr(ws, raws, nw)


def _gather_rows_expr(stream_be: jax.Array, offsets: jax.Array,
                      lens: jax.Array, nw: int) -> jax.Array:
    """(B, nw) frame word matrix gathered from a device-resident stream.

    ``stream_be`` is the stream's (W,) big-endian uint32 word values;
    frames start at arbitrary BYTE offsets, so each row gathers nw+1
    words at word granularity and funnel-shifts by the byte remainder —
    one whole-row gather plus one elementwise pass,
    instead of the 2 MiB host scatter the host staging pays per batch.
    Bytes past each frame's length are zeroed, bit-exactly matching the
    host scatter's tail memset (so malformed-stream poison semantics are
    identical between the two staging tiers).
    """
    W = stream_be.shape[0]
    # word base computed before the int32 narrowing so byte offsets past
    # 2 GiB still index correctly (word indices stay < 2^31 to 8 GiB)
    base = (offsets >> 2).astype(jnp.int32)
    off = offsets.astype(jnp.int32)
    ln = lens.astype(jnp.int32)
    idx = base[:, None] + jnp.arange(nw + 1, dtype=jnp.int32)[None, :]
    rows = jnp.take(stream_be, jnp.clip(idx, 0, W - 1), axis=0)
    s = ((off & 3) * 8)[:, None].astype(jnp.uint32)
    hi, lo = rows[:, :-1], rows[:, 1:]
    w = jnp.where(s == 0, hi,
                  (hi << s) | (lo >> (jnp.uint32(32) - jnp.maximum(
                      s, jnp.uint32(1)))))
    # zero tails: word j keeps its top (len - 4j) bytes, 0 past the end
    j4 = jnp.arange(nw, dtype=jnp.int32)[None, :] * 4
    keep = jnp.clip(ln[:, None] - j4, 0, 4).astype(jnp.uint32) * 8
    mask = jnp.where(keep == 0, jnp.uint32(0),
                     (~jnp.uint32(0)) << (jnp.uint32(32) - jnp.maximum(
                         keep, jnp.uint32(1))))
    return w & mask


@_dataclasses.dataclass(frozen=True)
class DeviceStream:
    """A compressed stream resident on device (see ``upload_stream``).

    Uploading the COMPRESSED bytes once and staging rows on device moves
    the layout work from the host (2 MiB scatter per batch, the
    sustained wrapper's bound) to the chip, and shrinks the host->device
    transfer by the compression ratio versus uploading word matrices.
    """

    words: jax.Array   # (W,) uint32, host byte order (see ``swap``)
    swap: bool         # True: device must byte-swap to BE word values
    nbytes: int        # valid stream length in bytes


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples", "nw",
                                             "swap", "do_csum"))
def _stream_decode_group_fused(cfg, stream_u32, offsets, lens, model,
                               n_samples: int, nw: int, swap: bool,
                               do_csum: bool, g_dyn=None,
                               outlier_dyn=None):
    """ONE dispatch: byte swap + device row gather/align + lockstep
    decode + batched checksum, all from the device-resident stream."""
    from ..ops.decode import decode_blocks_device
    from ..ops.xxh32_device import checksum_blocks_device

    s = _bswap32_expr(stream_u32) if swap else stream_u32
    words = _gather_rows_expr(s, offsets, lens, nw)
    samples, end_bits = decode_blocks_device(
        cfg, words, model, n_samples, g_dyn=g_dyn, outlier_dyn=outlier_dyn)
    csum = checksum_blocks_device(samples) if do_csum else None
    return samples, end_bits, csum


def _combine_staged(sts: "list[StagedFrames]", nw: int) -> StagedFrames:
    """Concatenate several stagings' header columns into one batch view
    (the coalesced launch's combined metadata)."""
    cat = np.concatenate
    comb = StagedFrames(
        words=None, raw=False, n_words=nw,
        prep=cat([s.prep for s in sts]), enc=cat([s.enc for s in sts]),
        cs=cat([s.cs for s in sts]), seq=cat([s.seq for s in sts]),
        g=cat([s.g for s in sts]),
        outlier=cat([s.outlier for s in sts]),
        csize=cat([s.csize for s in sts]),
        stored_csum=cat([s.stored_csum for s in sts]),
        nbytes=sum(s.nbytes for s in sts),
        uniform=all(s.uniform for s in sts) and len(
            {(int(s.prep[0]), int(s.enc[0]), int(s.cs[0]),
              int(s.g[0]), int(s.outlier[0]))
             for s in sts if s.prep.size}) <= 1)
    if all(s.row_off is not None for s in sts):
        comb = _dataclasses.replace(
            comb, row_off=cat([s.row_off for s in sts]),
            row_len=cat([s.row_len for s in sts]))
    return comb


@functools.partial(jax.jit, static_argnames=("nw", "swap"))
def _gather_rows_device(stream_u32, offsets, lens, nw: int, swap: bool):
    """Standalone gather program for the non-uniform (mixed-method)
    fallback: produces the (B, nw) BE word matrix decode_staged expects
    with ``raw=False`` semantics."""
    s = _bswap32_expr(stream_u32) if swap else stream_u32
    return _gather_rows_expr(s, offsets, lens, nw)


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples", "raws",
                                             "nw", "do_csum"))
def _stack_decode_group_fused(cfg, ws, model, n_samples: int,
                              raws: "tuple[bool, ...]", nw: int,
                              do_csum: bool, g_dyn=None, outlier_dyn=None):
    """ONE dispatch for a whole coalesced launch group: byte swap + pad +
    stack of every member batch's word matrix, the gridded lockstep
    decode over the stacked lanes, and the batched device checksum.  The
    grouped steady state re-dispatches this every ``group`` batches, so
    folding the stack into the decode program (instead of dispatching
    ``_stack_words`` separately) halves the launch count."""
    from ..ops.decode import decode_blocks_device
    from ..ops.xxh32_device import checksum_blocks_device

    words = _stack_words_expr(ws, raws, nw)
    samples, end_bits = decode_blocks_device(
        cfg, words, model, n_samples, g_dyn=g_dyn, outlier_dyn=outlier_dyn)
    csum = checksum_blocks_device(samples) if do_csum else None
    return samples, end_bits, csum


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples", "swap",
                                             "do_csum"))
def _decode_group_fused(cfg, words, model, n_samples: int, swap: bool,
                        do_csum: bool, g_dyn=None, outlier_dyn=None):
    """One DISPATCH for the whole per-batch decode graph.

    Byte swap + lockstep decode + device checksum composed under a
    single jit: one dispatch per batch instead of three.
    """
    from ..ops.decode import decode_blocks_device
    from ..ops.xxh32_device import checksum_blocks_device

    if swap:
        words = _bswap32_expr(words)
    samples, end_bits = decode_blocks_device(
        cfg, words, model, n_samples, g_dyn=g_dyn, outlier_dyn=outlier_dyn)
    csum = checksum_blocks_device(samples) if do_csum else None
    return samples, end_bits, csum


@_dataclasses.dataclass
class StagedFrames:
    """Host-staged batch: parsed header columns + the padded word matrix.

    Produced by :meth:`BatchDecompressor.stage_frames`; everything here
    is validated numpy (no Python per-frame state), ready for one
    ``jnp.asarray`` upload.  ``words`` holds the frame bytes viewed as
    native uint32 — on a little-endian host these are byte-swapped
    relative to the stream's big-endian word values (``raw=True``) and
    :meth:`BatchDecompressor.decode_staged` swaps them ON DEVICE (one
    fused elementwise pass; a host-side ``astype`` byteswap of the whole batch
    was a measurable share of wrapper decode time).
    """

    words: "np.ndarray"          # (B, n_words) uint32 (see ``raw``)
    raw: bool                    # True: device must byte-swap
    n_words: int
    prep: "np.ndarray"           # (B,) int32
    enc: "np.ndarray"            # (B,) int32
    cs: "np.ndarray"             # (B,) int32 0/1
    seq: "np.ndarray"            # (B,) int32
    g: "np.ndarray"              # (B,) uint32
    outlier: "np.ndarray"        # (B,) uint32
    csize: "np.ndarray"          # (B,) int64
    stored_csum: "np.ndarray"    # (B,) uint32 (0 where cs == 0)
    nbytes: int                  # total compressed input bytes
    # every block shares block 0's method byte + encoder parameters (the
    # common lockstep case): lets decode_staged skip its group scan
    uniform: bool = False
    # device-staged decode (stage_headers_at): frame spans inside a
    # device-resident stream; ``words`` is then None and the row
    # gather/layout happens ON DEVICE inside the decode dispatch
    row_off: "np.ndarray | None" = None   # (B,) int64 byte offsets
    row_len: "np.ndarray | None" = None   # (B,) int64 byte lengths


class _GroupFetch:
    """Fetch-once holder for a coalesced launch's stacked outputs.

    Every member of a grouped launch (:meth:`BatchDecompressor.
    decode_staged_multi`) shares one of these instead of carrying
    device-sliced views: slicing a device array is a dispatch, and a
    4-batch group would pay ~12 extra launches per group.  The first :meth:`host` call
    fetches the whole group's samples/end_bits/csum in ONE transfer;
    members then window the host arrays for free.
    """

    __slots__ = ("samples", "end_bits", "csum", "_host")

    def __init__(self, samples, end_bits, csum):
        self.samples, self.end_bits, self.csum = samples, end_bits, csum
        self._host = None

    def host(self):
        if self._host is None:
            want = [self.samples, self.end_bits]
            if self.csum is not None:
                want.append(self.csum)
            got = jax.device_get(want)
            self._host = (
                np.asarray(got[0]),
                np.asarray(got[1], np.int64),
                np.asarray(got[2], np.uint64) if self.csum is not None
                else None)
        return self._host


@_dataclasses.dataclass
class DecodedFrames:
    """Device-side decode result, integrity checks not yet applied.

    ``samples``/``end_bits``/``csum`` are device arrays; fetching them is
    the caller's (or :meth:`BatchDecompressor.finish`'s) choice, so a
    pipelined consumer can keep everything on device and defer the
    integrity fetch to a batch boundary.

    For members of a coalesced launch, ``group`` holds the shared
    :class:`_GroupFetch` and ``lo`` this member's first row in the
    stacked arrays (``samples``/``end_bits``/``csum`` then reference the
    FULL stacked device arrays — device-side slicing would cost a
    dispatch per member; :meth:`BatchDecompressor.finish` windows the
    one shared host fetch instead).
    """

    samples: jax.Array           # (B, N) int32
    end_bits: jax.Array          # (B,) payload end bit position
    csum: "jax.Array | None"     # (B,) uint32 computed XXH32, or None
    group: "_GroupFetch | None" = None
    lo: int = 0


# Staging validation outcomes by rank — shared by the numpy check matrix
# (_stage_from_buf) and the one-pass C parser (native.stage_parse); both
# implement the same ordered check list, so a given corrupt batch raises
# the same error either way.
_STAGE_CHECK_ERRORS = (
    (CmpErrorCode.INT_HDR, "header truncated"),
    (CmpErrorCode.INT_HDR, "extended header truncated"),
    (CmpErrorCode.INT_HDR, "frame shorter than header compressed_size"),
    (CmpErrorCode.SRC_SIZE_MISMATCH, None),
    (CmpErrorCode.INT_HDR, "unknown method"),
    (CmpErrorCode.PARAMS_INVALID, "bad Golomb parameter in header"),
    (CmpErrorCode.INT_HDR, "MODEL preprocessing on a primary pass"),
)


class BatchDecompressor:
    """Device decode of lockstep chains: B frames per call, model carried.

    Mirrors :class:`BatchCompressor` on the decode side.  The decode
    configuration of every block is taken from its parsed HEADER — the
    AIRSPACE header is self-describing (method byte at offset 15, per-
    block ``encoder_param``/``encoder_outlier`` in the extension,
    reference lib/common/header.c:89-134, header_private.h:23-31) — so
    all stream shapes decode correctly on device:

    * mixed primary/secondary batches (the state after a fallback reset
      one chain) decode under each method group present, selected per
      block;
    * uncompressed-fallback frames (NONE + UNCOMPRESSED) take a
      closed-form slice decode (ops.decode.decode_blocks_uncompressed);
    * adaptive streams (per-block Golomb parameter in the header,
      ops/adapt.py) decode in ONE device pass with per-lane parameters.

    Integrity contract (reference header.c:137-163): blocks whose method
    byte carries the checksum bit are verified against their trailing
    XXH32 with the batch-parallel device kernel
    (ops/xxh32_device.checksum_blocks_device); a mismatch raises
    ``CmpError`` exactly like the host decoder.  ``verify_checksum=False``
    opts out (same switch as the chunked tier).

    The generic per-block host decoder (engine/decode.py) remains the
    oracle for arbitrary streams.
    """

    def __init__(self, params: CmpParams, batch: int, n_samples: int,
                 cmp_type: CmpType = CmpType.U16,
                 verify_checksum: bool = True):
        params.validate()
        self.params = params
        self.batch = batch
        self.n_samples = n_samples
        self.cmp_type = cmp_type
        self.unsigned = cmp_type is CmpType.U16
        self.verify_checksum = verify_checksum
        self._expected_params_cache = None
        self.model = jnp.zeros((batch, n_samples), jnp.int32)
        from ..utils.profiling import ThroughputMeter

        self.metrics = ThroughputMeter()

    def _expected_enc_params(self) -> "set[tuple[int, int]]":
        """(g, outlier) pairs this decompressor's own params would emit."""
        if self._expected_params_cache is None:
            out = set()
            for cfg in (make_pass_config(self.params, False, self.unsigned),
                        make_pass_config(self.params, True, self.unsigned)
                        if self.params.secondary_iterations else None):
                if cfg is not None and cfg.enc_type != 0:
                    out.add((cfg.g_par, cfg.outlier))
            self._expected_params_cache = out
        return self._expected_params_cache

    def _group_cfg(self, prep: int, enc: int, cs: int, g_vals, o_vals):
        """Decode PassConfig for one header method group.

        Returns (cfg, g_dyn, outlier_dyn); the dynamic arrays are None
        when the group's parameters are uniform AND expected from this
        decompressor's own params (the common lockstep case — reuses the
        static-parameter compiled program).  Everything else — mixed
        parameters (adaptive streams) and uniform-but-unexpected values —
        takes the per-lane dynamic kernel with ``cfg.g_par`` bucketed to
        the next power of two, so the number of compiled programs is
        bounded by log2 of the parameter range, never by stream content
        (a stream with adversarial headers must not be able to force one
        fresh XLA compile per header value — found by the fuzz soak,
        which ran the process out of JIT code memory that way; the
        dynamic kernel benches within ~2% of the static one).
        """
        from ..ops.encode import PassConfig

        if enc == 0:
            cfg = PassConfig(prep, 0, 0, 0, bool(cs),
                             self.params.model_rate, prep == 3,
                             self.unsigned)
            return cfg, None, None
        uniform = (g_vals.min() == g_vals.max()
                   and o_vals.min() == o_vals.max())
        if uniform and (int(g_vals[0]),
                        int(o_vals[0])) in self._expected_enc_params():
            cfg = PassConfig(prep, enc, int(g_vals[0]), int(o_vals[0]),
                             bool(cs), self.params.model_rate, prep == 3,
                             self.unsigned)
            return cfg, None, None
        g_cap = 1 << max(int(g_vals.max()) - 1, 0).bit_length()
        cfg = PassConfig(prep, enc, g_cap, 0, bool(cs),
                         self.params.model_rate, prep == 3, self.unsigned)
        return cfg, g_vals, o_vals

    # -- staging (host, vectorized) --------------------------------------
    def stage_frames(self, frames: "list[bytes]") -> StagedFrames:
        """Parse + validate B frames into one padded word matrix.

        Native fast path: one ``b"".join`` pass plus one C scatter stages
        every frame (memcpy + tail memset per row — no buffer
        pre-zeroing), then a second C pass parses + validates the
        headers and extracts the checksum trailers (the vectorized-numpy
        parse/validate block was the wrapper's dominant staging cost at
        B=1024: ~30 numpy launches over tiny columns).  The numpy
        fallback reproduces the host decoder's per-frame check order
        exactly (first offending block raises its first failing check);
        the native path implements the identical check list.  Callers
        holding the frames inside ONE contiguous buffer should prefer
        :meth:`stage_frames_at`, which also skips the join.
        """
        if len(frames) != self.batch:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG)
        B = self.batch
        lens = np.fromiter((len(f) for f in frames), np.int64, count=B)
        n_words, stride = self._staging_geometry(lens)
        from .. import native

        if native.native_available():
            buf = np.empty((B, stride), np.uint8)  # C memsets row tails
            native.scatter_rows(b"".join(frames), lens, stride, buf)
            return self._stage_native(buf, lens, n_words)
        buf = np.zeros((B, stride), np.uint8)
        max_len = int(lens.max()) if B else 0
        if (lens == max_len).all():
            buf[:, :max_len] = np.frombuffer(
                b"".join(frames), np.uint8).reshape(B, max_len)
        else:
            for b, f in enumerate(frames):
                buf[b, : lens[b]] = np.frombuffer(f, np.uint8)
        return self._stage_from_buf(buf, lens, n_words)

    def stage_frames_at(self, stream: bytes, offsets, lens) -> StagedFrames:
        """Stage B frames that live inside ONE contiguous buffer.

        The concatenated-stream (file) decode path: blocks are located by
        (offset, length) pairs and staged straight from ``stream`` with
        one C scatter — no per-block slices, no re-join.  Same
        validation/parse path as :meth:`stage_frames`.
        """
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        if lens.size != self.batch or offsets.size != self.batch:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG)
        if (offsets < 0).any() or (lens < 0).any() or (
                offsets + lens > len(stream)).any():
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           "frame spans exceed the stream buffer")
        n_words, stride = self._staging_geometry(lens)
        from .. import native

        if native.native_available():
            buf = np.empty((self.batch, stride), np.uint8)  # C memsets tails
            native.scatter_rows_at(stream, offsets, lens, stride, buf)
            return self._stage_native(buf, lens, n_words)
        buf = np.zeros((self.batch, stride), np.uint8)
        sv = np.frombuffer(stream, np.uint8)
        for b in range(self.batch):
            buf[b, : lens[b]] = sv[offsets[b] : offsets[b] + lens[b]]
        return self._stage_from_buf(buf, lens, n_words)

    # -- device-staged decode (stream resident on device) ------------------
    def upload_stream(self, stream: bytes) -> DeviceStream:
        """Upload a compressed stream once for device-staged decode.

        Pads to word alignment plus two guard words (the row gather
        reads one word past each frame's span before masking).  Pair
        with :meth:`stage_headers_at` + :meth:`decode_staged_from`: the
        host then touches only ~22 bytes of header per frame instead of
        scattering the full payload into a word matrix, and the
        host->device transfer carries the COMPRESSED bytes.
        """
        import sys as _sys

        pad = (-len(stream)) % 4 + 8
        arr = np.frombuffer(stream + b"\0" * pad, np.uint32)
        return DeviceStream(words=jnp.asarray(arr),
                            swap=_sys.byteorder == "little",
                            nbytes=len(stream))

    def stage_headers_at(self, stream: bytes, offsets, lens) \
            -> StagedFrames:
        """Header-only staging for device-staged decode.

        Parses and validates every frame header straight out of
        ``stream`` (same check list/order as :meth:`stage_frames_at` —
        the differential staging tests assert equivalence) WITHOUT
        scattering payloads: the returned :class:`StagedFrames` carries
        the frame spans (``row_off``/``row_len``) and ``words=None``;
        :meth:`decode_staged_from` gathers the rows on device.
        """
        from ..format.header import (
            CMP_HDR_MAX_SIZE,
            CMP_HDR_SIZE,
            parse_headers_batch,
        )

        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        B = self.batch
        if lens.size != B or offsets.size != B:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG)
        if (offsets < 0).any() or (lens < 0).any() or (
                offsets + lens > len(stream)).any():
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           "frame spans exceed the stream buffer")
        n_words, stride = self._staging_geometry(lens)
        from .. import native

        if native.native_available():
            res = native.stage_parse_at(stream, offsets, lens,
                                        self.n_samples)
            if len(res) == 2:
                rank, block = res
                code, msg = _STAGE_CHECK_ERRORS[rank]
                raise CmpError(code, None if msg is None
                               else f"block {block}: {msg}")
            prep, enc, cs, seq, g, outlier, csize, stored, uniform = res
            return StagedFrames(
                words=None, raw=False, n_words=n_words,
                prep=prep, enc=enc, cs=cs, seq=seq, g=g, outlier=outlier,
                csize=csize, stored_csum=stored, nbytes=int(lens.sum()),
                uniform=uniform, row_off=offsets, row_len=lens)

        sv = np.frombuffer(stream, np.uint8)

        def gather_bytes(start, count):
            # (B, count) bytes from per-frame positions, 0 past the
            # frame's end (mirrors the host scatter's zero tails)
            idx = start[:, None] + np.arange(count)[None, :]
            valid = (np.arange(count)[None, :]
                     < (offsets + lens - start)[:, None]) & (start >= 0)[
                         :, None] & (idx < len(stream))
            return np.where(valid, sv[np.clip(idx, 0, max(len(sv) - 1,
                                                          0))], 0)

        hwidth = max(CMP_HDR_MAX_SIZE, 24)
        hbuf = gather_bytes(offsets, hwidth).astype(np.uint8)
        h = parse_headers_batch(hbuf)
        checks = (
            lens < CMP_HDR_SIZE,
            h.has_extension & (lens < CMP_HDR_MAX_SIZE),
            lens < h.compressed_size,
            h.original_size != 2 * self.n_samples,
            (h.preprocessing > 3) | (h.encoder_type > 2),
            ((h.encoder_type != 0)
             & ~((1 <= h.encoder_param) & (h.encoder_param <= 0xFFFF))),
            (h.preprocessing == 3) & (h.sequence_number == 0),
        )
        fail_rank = np.full(B, len(checks), np.int64)
        for rank, bad in reversed(list(enumerate(checks))):
            fail_rank = np.where(bad, rank, fail_rank)
        bad_blocks = np.nonzero(fail_rank < len(checks))[0]
        if bad_blocks.size:
            b = int(bad_blocks[0])
            code, msg = _STAGE_CHECK_ERRORS[int(fail_rank[b])]
            raise CmpError(code, None if msg is None
                           else f"block {b}: {msg}")

        tb = gather_bytes(offsets + h.compressed_size.astype(np.int64) - 4,
                          4).astype(np.uint32)
        stored = ((tb[:, 0] << 24) | (tb[:, 1] << 16)
                  | (tb[:, 2] << 8) | tb[:, 3])
        stored = np.where(h.checksum_enabled != 0, stored, 0)

        uniform = bool(
            (h.preprocessing == h.preprocessing[0]).all()
            and (h.encoder_type == h.encoder_type[0]).all()
            and (h.checksum_enabled == h.checksum_enabled[0]).all()
            and (h.encoder_param == h.encoder_param[0]).all()
            and (h.encoder_outlier == h.encoder_outlier[0]).all()) \
            if B else True

        return StagedFrames(
            words=None, raw=False, n_words=n_words,
            prep=h.preprocessing, enc=h.encoder_type,
            cs=h.checksum_enabled, seq=h.sequence_number,
            g=h.encoder_param, outlier=h.encoder_outlier,
            csize=h.compressed_size, stored_csum=stored.astype(np.uint32),
            nbytes=int(lens.sum()), uniform=uniform,
            row_off=offsets, row_len=lens)

    def decode_staged_from(self, st: StagedFrames, ds: DeviceStream,
                           offsets_dev: "jax.Array | None" = None,
                           lens_dev: "jax.Array | None" = None) \
            -> DecodedFrames:
        """Decode a header-staged batch straight from the device stream.

        The common lockstep case (uniform method group) runs byte swap +
        row gather/align + decode + checksum as ONE fused dispatch;
        mixed-method batches gather first, then reuse the per-group
        dispatch of :meth:`decode_staged`.  ``offsets_dev``/``lens_dev``
        let a steady-state caller keep the span arrays device-resident
        across calls instead of re-uploading (B,) arrays per dispatch.
        """
        if st.row_off is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "decode_staged_from needs stage_headers_at "
                           "staging (row spans missing)")
        B = st.prep.shape[0]
        off = (offsets_dev if offsets_dev is not None
               else jnp.asarray(st.row_off.astype(np.int32)))
        ln = (lens_dev if lens_dev is not None
              else jnp.asarray(st.row_len.astype(np.int32)))

        from ..ops.xxh32_device import use_device_checksum

        if st.uniform and st.prep.size and not (
                int(st.prep[0]) == 0 and int(st.enc[0]) == 0):
            prep, enc, cs = int(st.prep[0]), int(st.enc[0]), int(st.cs[0])
            cfg, g_dyn, o_dyn = self._group_cfg(prep, enc, cs, st.g,
                                                st.outlier)
            want_csum = (self.verify_checksum and cs != 0
                         and use_device_checksum(self.n_samples))
            model = (self.model if B == self.batch
                     else self._zero_model(B))
            samples, end_bits, csum = _stream_decode_group_fused(
                cfg, ds.words, off, ln, model, self.n_samples,
                st.n_words, ds.swap, want_csum,
                None if g_dyn is None else jnp.asarray(g_dyn),
                None if o_dyn is None else jnp.asarray(o_dyn))
            if self.params.model_is_needed() and B == self.batch:
                self.model = model_update_step(
                    samples, model, jnp.asarray(st.seq),
                    jnp.zeros((B,), bool),
                    self.params.model_rate, self.cmp_type is CmpType.U16)
            return DecodedFrames(samples=samples, end_bits=end_bits,
                                 csum=csum)
        words = _gather_rows_device(ds.words, off, ln, st.n_words,
                                    ds.swap)
        return self.decode_staged(st, words_dev=words)

    def decode_staged_from_multi(self, sts: "list[StagedFrames]",
                                 ds: DeviceStream,
                                 offsets_dev: "jax.Array | None" = None,
                                 lens_dev: "jax.Array | None" = None) \
            -> "list[DecodedFrames]":
        """Grouped device-staged decode: several header-staged batches,
        ONE fused dispatch (swap + row gather + gridded decode +
        checksum) straight from the device-resident stream — the launch
        grouping of :meth:`decode_staged_multi` composed with the
        device staging of :meth:`decode_staged_from`.
        ``offsets_dev``/``lens_dev`` optionally carry the GROUP's
        concatenated spans device-resident.  Stateless streams only.
        """
        if len(sts) == 1:
            return [self.decode_staged_from(sts[0], ds, offsets_dev,
                                            lens_dev)]
        if self.params.model_is_needed():
            raise CmpError(
                CmpErrorCode.PARAMS_INVALID,
                "coalesced decode requires stateless (non-MODEL) streams")
        if any(s.row_off is None for s in sts):
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "decode_staged_from_multi needs "
                           "stage_headers_at staging (row spans missing)")
        nw = max(s.n_words for s in sts)
        comb = _combine_staged(sts, nw)
        dec = self.decode_staged_from(comb, ds, offsets_dev, lens_dev)
        shared = _GroupFetch(dec.samples, dec.end_bits, dec.csum)
        outs = []
        o = 0
        for s in sts:
            outs.append(DecodedFrames(
                samples=dec.samples, end_bits=dec.end_bits, csum=dec.csum,
                group=shared, lo=o))
            o += s.prep.shape[0]
        return outs

    @staticmethod
    def _staging_geometry(lens: "np.ndarray") -> "tuple[int, int]":
        max_len = int(lens.max()) if lens.size else 0
        n_words = (max_len + 3) // 4 + 2
        # bucket the buffer width so repeated calls with slightly
        # different frame sizes reuse one compiled decode program; the
        # floor keeps stride >= CMP_HDR_MAX_SIZE so the vectorized
        # header parse is in bounds even when EVERY frame is truncated
        # (those batches must raise CmpError, not IndexError)
        n_words = 1 << max((n_words - 1).bit_length(), 3)
        return n_words, n_words * 4

    def _stage_native(self, buf: "np.ndarray", lens: "np.ndarray",
                      n_words: int) -> StagedFrames:
        """Header parse + validation via the one-pass C core.

        Same check list/order and column layout as the numpy path in
        :meth:`_stage_from_buf` (asserted equivalent by the differential
        staging tests); returns the identical StagedFrames.
        """
        from .. import native

        res = native.stage_parse(buf, lens, self.n_samples)
        if len(res) == 2:
            rank, block = res
            code, msg = _STAGE_CHECK_ERRORS[rank]
            raise CmpError(code, None if msg is None
                           else f"block {block}: {msg}")
        prep, enc, cs, seq, g, outlier, csize, stored, uniform = res
        import sys as _sys

        return StagedFrames(
            words=buf.view(np.uint32), raw=_sys.byteorder == "little",
            n_words=n_words, prep=prep, enc=enc, cs=cs, seq=seq, g=g,
            outlier=outlier, csize=csize, stored_csum=stored,
            nbytes=int(lens.sum()), uniform=uniform)

    def _stage_from_buf(self, buf: "np.ndarray", lens: "np.ndarray",
                        n_words: int) -> StagedFrames:
        from ..format.header import (
            CMP_HDR_MAX_SIZE,
            CMP_HDR_SIZE,
            parse_headers_batch,
        )

        B = self.batch
        stride = n_words * 4
        h = parse_headers_batch(buf)
        # validation, same per-frame order as CmpHeader.deserialize + the
        # host decoder's guards: for each frame the FIRST failing check
        # wins; the first failing frame raises.  Predicate order matches
        # _STAGE_CHECK_ERRORS (and the C parser's rank order).
        checks = (
            lens < CMP_HDR_SIZE,
            h.has_extension & (lens < CMP_HDR_MAX_SIZE),
            lens < h.compressed_size,
            h.original_size != 2 * self.n_samples,
            (h.preprocessing > 3) | (h.encoder_type > 2),
            ((h.encoder_type != 0)
             & ~((1 <= h.encoder_param) & (h.encoder_param <= 0xFFFF))),
            # MODEL preprocessing needs prior chain state; no encoder
            # emits it on a primary pass (reference cmp.c:228-254 — the
            # seq-0 pass reseeds the model instead), so a seq-0 MODEL
            # header is corrupt (same rule as the chunked host path)
            (h.preprocessing == 3) & (h.sequence_number == 0),
        )
        fail_rank = np.full(B, len(checks), np.int64)
        for rank, bad in reversed(list(enumerate(checks))):
            fail_rank = np.where(bad, rank, fail_rank)
        bad_blocks = np.nonzero(fail_rank < len(checks))[0]
        if bad_blocks.size:
            b = int(bad_blocks[0])
            code, msg = _STAGE_CHECK_ERRORS[int(fail_rank[b])]
            raise CmpError(code, None if msg is None
                           else f"block {b}: {msg}")

        # trailing stored checksum bytes (BE u32 at compressed_size - 4)
        idx = np.clip(h.compressed_size[:, None] - 4
                      + np.arange(4)[None, :], 0, stride - 1)
        tb = np.take_along_axis(buf, idx, axis=1).astype(np.uint32)
        stored = ((tb[:, 0] << 24) | (tb[:, 1] << 16)
                  | (tb[:, 2] << 8) | tb[:, 3])
        stored = np.where(h.checksum_enabled != 0, stored, 0)

        import sys as _sys

        uniform = bool(
            (h.preprocessing == h.preprocessing[0]).all()
            and (h.encoder_type == h.encoder_type[0]).all()
            and (h.checksum_enabled == h.checksum_enabled[0]).all()
            and (h.encoder_param == h.encoder_param[0]).all()
            and (h.encoder_outlier == h.encoder_outlier[0]).all()) \
            if B else True

        # on a little-endian host the raw u32 view is byte-swapped
        # relative to the stream's BE word values; the device swaps
        return StagedFrames(
            words=buf.view(np.uint32), raw=_sys.byteorder == "little",
            n_words=n_words,
            prep=h.preprocessing, enc=h.encoder_type,
            cs=h.checksum_enabled, seq=h.sequence_number,
            g=h.encoder_param, outlier=h.encoder_outlier,
            csize=h.compressed_size, stored_csum=stored.astype(np.uint32),
            nbytes=int(lens.sum()), uniform=uniform)

    # -- device decode ----------------------------------------------------
    def _zero_model(self, B: int) -> jax.Array:
        """Per-lane-count zero model for coalesced launches, cached —
        steady-state grouped launches re-dispatch every group and must
        not re-allocate (or re-upload) it."""
        cache = getattr(self, "_zero_models", None)
        if cache is None:
            cache = self._zero_models = {}
        model = cache.get(B)
        if model is None:
            model = cache[B] = jnp.zeros((B, self.n_samples), jnp.int32)
        return model

    def decode_staged(self, st: StagedFrames,
                      words_dev: "jax.Array | None" = None) -> DecodedFrames:
        """Run the device decode passes for a staged batch.

        ``words_dev`` lets a caller reuse an already-uploaded word matrix
        (``st.words`` verbatim — the byte swap, when pending, happens
        here on device); everything returned stays on device — no host
        sync happens here.  The model-chain transition also happens here
        (device-side, asynchronous), so a pipelined caller can stage and
        decode batch k+1 before fetching batch k's results without
        breaking MODEL-preprocessing chain order; :meth:`finish` only
        verifies integrity and fetches.
        """
        from ..ops.decode import (
            decode_blocks_device,
            decode_blocks_uncompressed,
        )

        B = st.prep.shape[0]
        if words_dev is None:
            words_dev = jnp.asarray(st.words)

        model = self.model
        if B != self.batch:
            # coalesced multi-batch launch (decode_staged_multi): only
            # stateless configs may coalesce, so a zero model is correct
            model = self._zero_model(B)

        from ..ops.xxh32_device import use_device_checksum

        want_csum = (self.verify_checksum and (st.cs != 0).any()
                     and use_device_checksum(self.n_samples))

        # header-driven dispatch: one device pass per method group
        # present.  The common lockstep case (ONE compressed group) runs
        # byte swap + decode + checksum as a single fused dispatch;
        # ``st.uniform`` (computed during the C stage parse) skips the
        # group scan entirely on that path.
        if st.uniform and st.prep.size:
            keys = None
            prep, enc, cs = int(st.prep[0]), int(st.enc[0]), int(st.cs[0])
        else:
            key = (st.prep.astype(np.int64) * 16 + st.enc * 2 + st.cs)
            keys = np.unique(key)
            if len(keys) == 1:
                prep, enc, cs = (int(keys[0]) // 16,
                                 (int(keys[0]) // 2) % 8, int(keys[0]) % 2)
        if keys is None or len(keys) == 1:
            if not (prep == 0 and enc == 0):
                cfg, g_dyn, o_dyn = self._group_cfg(prep, enc, cs, st.g,
                                                    st.outlier)
                samples, end_bits, csum = _decode_group_fused(
                    cfg, words_dev, model, self.n_samples, st.raw,
                    want_csum,
                    None if g_dyn is None else jnp.asarray(g_dyn),
                    None if o_dyn is None else jnp.asarray(o_dyn))
                if self.params.model_is_needed() and B == self.batch:
                    self.model = model_update_step(
                        samples, model, jnp.asarray(st.seq),
                        jnp.zeros((B,), bool),
                        self.params.model_rate,
                        self.cmp_type is CmpType.U16)
                return DecodedFrames(samples=samples, end_bits=end_bits,
                                     csum=csum)

        if st.raw:
            words_dev = bswap32(words_dev)
        if keys is None:  # uniform uncompressed batch fell through
            key = (st.prep.astype(np.int64) * 16 + st.enc * 2 + st.cs)
            keys = np.unique(key)
        samples = None
        end_bits = None
        for k in keys:
            mask = key == k
            prep, enc, cs = int(k) // 16, (int(k) // 2) % 8, int(k) % 2
            if prep == 0 and enc == 0:
                s = decode_blocks_uncompressed(words_dev, self.n_samples)
                e = jnp.full((B,), 128 + 16 * self.n_samples, jnp.int32)
            else:
                cfg, g_dyn, o_dyn = self._group_cfg(
                    prep, enc, cs, st.g[mask], st.outlier[mask])
                if g_dyn is not None:
                    # full-batch per-lane parameters (masked lanes decode
                    # garbage, discarded by the select below)
                    s, e = decode_blocks_device(
                        cfg, words_dev, model, self.n_samples,
                        g_dyn=jnp.asarray(np.where(mask, st.g, 1)),
                        outlier_dyn=jnp.asarray(np.where(mask, st.outlier,
                                                         1)))
                else:
                    s, e = decode_blocks_device(
                        cfg, words_dev, model, self.n_samples)
            if samples is None:
                samples, end_bits = s, e
            else:
                m = jnp.asarray(mask)
                samples = jnp.where(m[:, None], s, samples)
                end_bits = jnp.where(m, e.astype(end_bits.dtype), end_bits)

        csum = None
        if want_csum:
            from ..ops.xxh32_device import checksum_blocks_device

            csum = checksum_blocks_device(samples)
        # when the device checksum is routed off, finish() verifies on
        # host with the native xxhash fast path once the samples are
        # fetched (use_device_checksum governs every tier)

        # model transition identical to the encoder's: per-block seq;
        # fallback frames carry seq 0, which reseeds the model exactly as
        # the encoder's fallback reseed does (cmp.c:380-392 + :304-311).
        # Runs here (not in finish) so back-to-back decode_staged calls
        # chain correctly even when their finishes are deferred.
        if self.params.model_is_needed() and B == self.batch:
            self.model = model_update_step(
                samples, model, jnp.asarray(st.seq),
                jnp.zeros((B,), bool),
                self.params.model_rate, self.cmp_type is CmpType.U16)
        return DecodedFrames(samples=samples, end_bits=end_bits, csum=csum)

    def decode_staged_multi(self, sts: "list[StagedFrames]",
                            words_dev: "list[jax.Array] | None" = None) \
            -> "list[DecodedFrames]":
        """Decode several staged batches in ONE device launch.

        Coalesces several batches (e.g. two B=512 stagings) into a
        single decode dispatch, amortizing the per-dispatch launch and
        host overhead over more lanes.  Only stateless
        streams may coalesce (MODEL preprocessing carries per-call chain
        state); the caller guarantees every staged batch belongs to this
        decompressor's geometry.  ``words_dev`` optionally reuses
        already-uploaded word matrices (same contract as
        :meth:`decode_staged`).  Returns one DecodedFrames per input, in
        order (device-resident; finish each against its own staging).
        """
        if len(sts) == 1:
            return [self.decode_staged(
                sts[0], None if words_dev is None else words_dev[0])]
        if self.params.model_is_needed():
            raise CmpError(
                CmpErrorCode.PARAMS_INVALID,
                "coalesced decode requires stateless (non-MODEL) streams")
        nw = max(s.n_words for s in sts)
        ws = [jnp.asarray(s.words) if words_dev is None else words_dev[i]
              for i, s in enumerate(sts)]
        comb = _combine_staged(sts, nw)
        if comb.uniform and comb.prep.size and not (
                int(comb.prep[0]) == 0 and int(comb.enc[0]) == 0):
            # lockstep group: fold the swap/pad/stack into the decode
            # program itself — the whole coalesced launch is ONE dispatch
            from ..ops.xxh32_device import use_device_checksum

            prep, enc, cs = (int(comb.prep[0]), int(comb.enc[0]),
                             int(comb.cs[0]))
            cfg, g_dyn, o_dyn = self._group_cfg(prep, enc, cs, comb.g,
                                                comb.outlier)
            want_csum = (self.verify_checksum and cs != 0
                         and use_device_checksum(self.n_samples))
            samples, end_bits, csum = _stack_decode_group_fused(
                cfg, tuple(ws), self._zero_model(comb.prep.shape[0]),
                self.n_samples, tuple(s.raw for s in sts), nw, want_csum,
                None if g_dyn is None else jnp.asarray(g_dyn),
                None if o_dyn is None else jnp.asarray(o_dyn))
            dec = DecodedFrames(samples=samples, end_bits=end_bits,
                                csum=csum)
        else:
            stacked = _stack_words(ws, tuple(s.raw for s in sts), nw)
            dec = self.decode_staged(comb, words_dev=stacked)
        shared = _GroupFetch(dec.samples, dec.end_bits, dec.csum)
        outs = []
        o = 0
        for s in sts:
            outs.append(DecodedFrames(
                samples=dec.samples, end_bits=dec.end_bits, csum=dec.csum,
                group=shared, lo=o))
            o += s.prep.shape[0]
        return outs

    # -- integrity + fetch -------------------------------------------------
    def finish(self, st: StagedFrames, dec: DecodedFrames) -> np.ndarray:
        """Verify integrity and fetch the samples.

        The model-chain transition already happened (device-side) in
        :meth:`decode_staged`; this is the only host sync point, so a
        pipelined caller defers it past the next batch's staging.
        """
        B = st.csize.shape[0]
        if dec.group is not None:
            # coalesced member: ONE shared fetch for the whole launch
            # group, windowed here on host (device-side slicing would
            # cost a dispatch per member)
            s_all, e_all, c_all = dec.group.host()
            w = slice(dec.lo, dec.lo + B)
            end_np = e_all[w]
            samples_np = s_all[w]
            calc_np = None if c_all is None else c_all[w]
        else:
            fetch = [dec.end_bits]
            if dec.csum is not None:
                fetch.append(dec.csum)
            fetched = jax.device_get(fetch)
            end_np = np.asarray(fetched[0], np.int64)
            samples_np = None
            calc_np = (np.asarray(fetched[1], np.uint64)
                       if dec.csum is not None else None)

        # bitstream-exhaustion check, mirroring the host decoder's
        # "payload exceeds compressed_size" guard (engine/host.py): a
        # corrupt payload must raise, never silently return garbage
        limit = st.csize - np.where(st.cs != 0, 4, 0)
        over = np.nonzero((end_np + 7) // 8 > limit)[0]
        if over.size:
            raise CmpError(
                CmpErrorCode.INT_BITSTREAM,
                f"block {int(over[0])}: payload exceeds compressed_size")

        # XXH32 trailer enforcement (reference header.c:137-163: the
        # checksum bit is part of the block contract; the host and
        # chunked tiers already raise on mismatch — so does this one).
        # decode_staged computed the checksums on device when the
        # backend routing allows; otherwise verify here on host with the
        # native xxhash fast path over the fetched samples.
        if samples_np is None:
            samples_np = np.asarray(dec.samples)
        out = samples_np.astype(np.int32).astype(np.uint16)
        if calc_np is not None:
            calc = calc_np
            bad = np.nonzero((st.cs != 0)
                             & (calc != st.stored_csum.astype(np.uint64)))[0]
        elif self.verify_checksum and (st.cs != 0).any():
            calc = np.fromiter(
                (cmp_checksum(out[b]) if st.cs[b] else 0
                 for b in range(B)),
                np.uint64, count=B)
            bad = np.nonzero((st.cs != 0)
                             & (calc != st.stored_csum.astype(np.uint64)))[0]
        else:
            bad = np.empty(0, np.int64)
        if bad.size:
            b = int(bad[0])
            raise CmpError(
                CmpErrorCode.GENERIC,
                f"block {b}: checksum mismatch: stored "
                f"{int(st.stored_csum[b]):#010x} != computed "
                f"{int(calc[b]):#010x}")
        return out

    def decompress_frames(self, frames: "list[bytes]") -> np.ndarray:
        """Decode one AIRSPACE frame per chain -> (B, N) uint16 samples."""
        import time as _time

        _t0 = _time.perf_counter()
        st = self.stage_frames(frames)
        dec = self.decode_staged(st)
        out = self.finish(st, dec)
        self.metrics.record(st.nbytes, out.nbytes,
                            _time.perf_counter() - _t0)
        return out

    #: lane budget per coalesced launch: one dispatch can decode several
    #: batches; 4096 lanes amortizes per-dispatch launch latency while
    #: the stacked word matrix + samples stay small (~10 MB words + 16 MB
    #: samples at N=1024).
    COALESCE_LANES = 4096

    def _coalesce_group(self, coalesce: "bool | int | None") -> int:
        """Resolve the ``coalesce`` argument to a launch group size."""
        if coalesce is None:
            if self.params.model_is_needed():
                return 1
            return max(1, min(8, self.COALESCE_LANES // max(self.batch, 1)))
        if coalesce is False:
            return 1
        if coalesce is True:
            # explicit True: caller demands coalescing — surface the
            # stateless-only restriction instead of degrading silently
            if self.params.model_is_needed():
                raise CmpError(
                    CmpErrorCode.PARAMS_INVALID,
                    "coalesced decode requires stateless (non-MODEL) "
                    "streams")
            return max(2, min(8, self.COALESCE_LANES // max(self.batch, 1)))
        group = int(coalesce)
        if group < 1:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           f"coalesce group must be >= 1, got {group}")
        if group > 1 and self.params.model_is_needed():
            raise CmpError(
                CmpErrorCode.PARAMS_INVALID,
                "coalesced decode requires stateless (non-MODEL) streams")
        return group

    def decompress_stream(self, batches,
                          coalesce: "bool | int | None" = None,
                          depth: int = 1):
        """Pipelined decode over consecutive batches (a generator).

        ``batches`` yields either ``list[bytes]`` (staged here) or
        pre-built :class:`StagedFrames` (e.g. from
        :meth:`stage_frames_at` over a file buffer).  Device decodes are
        dispatched asynchronously and their host-side ``finish`` (the
        only sync point) is deferred ``depth`` launches, so batch k+1's
        host staging overlaps batch k's device decode — the double-
        buffering that takes the public wrapper from serial
        stage-then-decode to device-bound.

        ``coalesce`` stacks consecutive staged batches into ONE kernel
        launch (:meth:`decode_staged_multi`): a multi-batch launch puts
        more blocks in flight per dispatch and amortizes per-dispatch
        launch latency.  Pass an int
        for an explicit launch group size, ``True`` for the automatic
        group (up to :attr:`COALESCE_LANES` lanes per launch), or
        ``False`` to dispatch per batch.  Only stateless (non-MODEL)
        streams may coalesce; the default picks the automatic group for
        stateless streams and per-batch dispatch otherwise.  Grouping
        trades ``group - 1`` batches of latency for throughput.

        Yields one (B, N) uint16 array per input batch, in order.
        """
        from collections import deque

        group = self._coalesce_group(coalesce)
        in_flight = max(1, depth) * group
        pending: "deque[tuple[StagedFrames, DecodedFrames]]" = deque()
        acc: "list[StagedFrames]" = []
        for item in batches:
            acc.append(item if isinstance(item, StagedFrames)
                       else self.stage_frames(item))
            if len(acc) < group:
                continue
            pending.extend(zip(acc, self.decode_staged_multi(acc)))
            acc = []
            while len(pending) > in_flight:
                yield self.finish(*pending.popleft())
        if acc:
            pending.extend(zip(acc, self.decode_staged_multi(acc)))
        while pending:
            yield self.finish(*pending.popleft())

    def decompress_file_stream(self, stream: bytes, offsets, lens,
                               coalesce: "bool | int | None" = None,
                               depth: int = 1):
        """Device-staged pipelined decode of a whole frame manifest.

        The compressed ``stream`` is uploaded ONCE (:meth:`upload_
        stream` — the transfer carries the compressed bytes, smaller
        than the decode word matrices by the compression ratio); then
        consecutive windows of ``batch`` frames are header-staged on
        host (~30 bytes touched per frame, no payload scatter) and
        decoded by grouped fused dispatches that gather/align the rows
        ON DEVICE.  ``offsets``/``lens`` locate every frame; the frame
        count must be a multiple of ``batch`` (pad the manifest with a
        repeat of the last frame and drop the tail rows otherwise, as
        models/chunked.py does).  ``coalesce``/``depth`` as in
        :meth:`decompress_stream`.

        Yields one (B, N) uint16 array per window, in order.
        """
        from collections import deque

        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        B = self.batch
        if lens.size != offsets.size or lens.size % B:
            raise CmpError(
                CmpErrorCode.SRC_SIZE_WRONG,
                "manifest length must be a multiple of the batch size")
        ds = self.upload_stream(stream)
        group = self._coalesce_group(coalesce)
        in_flight = max(1, depth) * group
        pending: "deque[tuple[StagedFrames, DecodedFrames]]" = deque()
        acc: "list[StagedFrames]" = []
        for w in range(lens.size // B):
            acc.append(self.stage_headers_at(
                stream, offsets[w * B:(w + 1) * B],
                lens[w * B:(w + 1) * B]))
            if len(acc) < group:
                continue
            pending.extend(zip(acc,
                               self.decode_staged_from_multi(acc, ds)))
            acc = []
            while len(pending) > in_flight:
                yield self.finish(*pending.popleft())
        if acc:
            pending.extend(zip(acc, self.decode_staged_from_multi(acc,
                                                                  ds)))
        while pending:
            yield self.finish(*pending.popleft())
