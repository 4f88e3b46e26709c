"""Stream parallelism: one huge block split across devices (shard_map).

The codec's analog of sequence/context parallelism (SURVEY §2.5): a single
AIRSPACE block too large for one chip's comfort is split along the sample
axis over the mesh.  Communication pattern (XLA collectives; NCCL over
NVLink between the GPUs of one host):

* DIFF preprocessing needs a 1-sample halo — the previous shard's last
  sample — exchanged with ``ppermute``.
* IWT (reference lib/compress/preprocess.c:140-221) needs per-level halos:
  each lifting level's odd (detail) and even (approximation) passes each
  read one subsequence neighbor across the shard boundary, so a level is
  four 1-element ``ppermute`` exchanges.  Once the subsequence is down to
  one element per shard the remaining (tiny) levels are computed
  redundantly on every shard from one small ``all_gather``.
* MODEL preprocessing is elementwise — the model state shards with the
  stream; no communication.
* Per-shard codeword bit lengths are ``all_gather``-ed to derive each
  shard's absolute bit offset in the single payload (an exclusive scan of
  D scalars).
* Each shard bit-packs locally at offset 0 (ops/bitpack.pack_codes_tree),
  then funnel-shifts its word
  stream by (offset mod 32): the result lands on the global 32-bit word
  grid starting at word offset/32.  Adjacent shards overlap in exactly one
  boundary word, OR-merged during assembly.
* The XXH32 checksum is accumulated shard-by-shard with the streaming
  state (utils/xxh32.XXH32State) — no full-stream replay on any host.

:class:`LongStreamCompressor` carries the multi-pass chain state
(sequence number, identifier, model) with the exact semantics of one
reference context (cmp.c:213-393), including the uncompressed fallback.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..format.errors import CmpError, CmpErrorCode
from ..format.header import CMP_HDR_SIZE, CmpHeader
from ..format.params import CmpParams, EncoderType, Preprocessing
from ..ops import bitpack, golomb
from ..ops.encode import make_pass_config
from ..ops.preprocess import model_forward, model_update, wrap16
from ..ops.preprocess import _iwt_level as _iwt_level_local
from ..utils.xxh32 import cmp_checksum_chunked

__all__ = ["compress_long_stream", "LongStreamCompressor",
           "stream_chunk_index", "decompress_long_stream",
           "ChunkedLongStreamEncoder"]


# -- sharded IWT -----------------------------------------------------------

def _halo_from_left(v, axis, D):
    """Each shard receives the previous shard's ``v`` (ring shift right)."""
    return jax.lax.ppermute(v, axis, [(i, (i + 1) % D) for i in range(D)])


def _halo_from_right(v, axis, D):
    """Each shard receives the next shard's ``v`` (ring shift left)."""
    return jax.lax.ppermute(v, axis, [(i, (i - 1) % D) for i in range(D)])


def _iwt_level_sharded(xs, axis, D):
    """One lifting level over a sharded subsequence (local view (m_loc,)).

    Bit-identical to ops.preprocess._iwt_level on the concatenated global
    subsequence: the odd (detail) pass reads original neighbors, the even
    (approximation) pass reads detail-updated neighbors, so each pass
    exchanges one boundary element in each direction.  The global-edge
    special cases (j == 0 / j == m-1, reference preprocess.c:147-171)
    apply only on the first/last shard and mask out the wrapped halos.
    """
    m_loc = xs.shape[-1]
    m = m_loc * D
    d = jax.lax.axis_index(axis)
    j = d * m_loc + jnp.arange(m_loc)          # global subsequence index
    is_odd = (j & 1) == 1
    left = jnp.concatenate([_halo_from_left(xs[-1:], axis, D), xs[:-1]])
    right = jnp.concatenate([xs[1:], _halo_from_right(xs[:1], axis, D)])
    det = jnp.where(j == m - 1, xs - left, xs - ((left + right) >> 1))
    y = jnp.where(is_odd, wrap16(det), xs)
    yl = jnp.concatenate([_halo_from_left(y[-1:], axis, D), y[:-1]])
    yr = jnp.concatenate([y[1:], _halo_from_right(y[:1], axis, D)])
    app = xs + ((yl + yr) >> 2)
    app = jnp.where(j == 0, xs + (yr >> 1), app)
    app = jnp.where(j == m - 1, xs + (yl >> 1), app)
    return jnp.where(is_odd, y, wrap16(app))


def _iwt_forward_sharded(x_loc, axis, D, n):
    """Multi-level IWT of a length-n stream sharded as (n/D,) per device.

    Levels with >= 2 subsequence elements per shard run locally with halo
    exchanges; the remaining subsequence (exactly D elements when n/D is a
    power of two) is all-gathered once and the deep levels are computed
    redundantly per shard — O(D) elements of compute and communication.
    """
    L = x_loc.shape[-1]
    out = x_loc
    s = 1
    while s < n and L % s == 0 and L // s >= 2:
        out = out.at[::s].set(_iwt_level_sharded(out[::s], axis, D))
        s <<= 1
    if s < n:
        m_loc = L // s                          # == 1 for power-of-two L
        sub = out[::s]
        g = jax.lax.all_gather(sub, axis).reshape(-1)   # (n // s,)
        t = s
        while t < n:
            st = t // s
            g = g.at[::st].set(_iwt_level_local(g[::st], inverse=False))
            t <<= 1
        d = jax.lax.axis_index(axis)
        mine = jax.lax.dynamic_slice(g, (d * m_loc,), (m_loc,))
        out = out.at[::s].set(mine)
    return out


# -- sharded residual computation -------------------------------------------

def _shard_residuals(cfg, x_loc, model_loc, axis, D, n):
    """Per-shard preprocessing under ``cfg`` (all four methods)."""
    if cfg.prep == int(Preprocessing.NONE):
        return x_loc
    if cfg.prep == int(Preprocessing.DIFF):
        d = jax.lax.axis_index(axis)
        prev_last = _halo_from_left(x_loc[-1:], axis, D)
        prev = jnp.concatenate([prev_last, x_loc[:-1]])
        res = wrap16(x_loc - prev)
        # the very first sample of the stream is stored raw (d[0]=x[0])
        return jnp.where((d == 0) & (jnp.arange(x_loc.shape[0]) == 0),
                         wrap16(x_loc), res)
    if cfg.prep == int(Preprocessing.IWT):
        return _iwt_forward_sharded(x_loc, axis, D, n)
    if cfg.prep == int(Preprocessing.MODEL):
        return model_forward(x_loc, model_loc)
    raise CmpError(CmpErrorCode.PARAMS_INVALID,
                   f"unknown preprocessing {cfg.prep}")


def _shard_encode(x_loc, model_loc, cfg, axis, D, n):
    """Per-shard: residuals -> codewords -> local pack -> global shift."""
    d = jax.lax.axis_index(axis)
    res = _shard_residuals(cfg, x_loc, model_loc, axis, D, n)
    hi, lo, lens = golomb.encode_codewords(res, cfg.enc_type, cfg.g_par,
                                           cfg.outlier)
    n_loc = lens.shape[-1]
    K = 1 << (n_loc - 1).bit_length() if n_loc > 1 else 1
    if K != n_loc:
        pad = jnp.zeros((K - n_loc,), jnp.uint32)
        hi = jnp.concatenate([hi, pad])
        lo = jnp.concatenate([lo, pad])
        lens = jnp.concatenate([lens, jnp.zeros((K - n_loc,), jnp.int32)])
    local_bits = jnp.sum(lens)
    all_bits = jax.lax.all_gather(local_bits, axis)  # (D,)
    before = jnp.sum(jnp.where(jnp.arange(all_bits.shape[0]) < d, all_bits, 0))
    offset = cfg.hdr_bits + before  # absolute payload bit offset
    total_payload_bits = jnp.sum(all_bits)

    words, _ = bitpack.pack_codes_tree(hi, lo, lens,
                                       cfg.worst_bits_per_sample)
    # shift local stream right by r = offset % 32 onto the global word grid
    r = (offset % 32).astype(jnp.uint32)
    wprev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), words[:-1]])
    shift_hi = jnp.where(r == 0, jnp.uint32(0),
                         wprev << jnp.where(r == 0, jnp.uint32(0),
                                            jnp.uint32(32) - r))
    shifted = (words >> r) | shift_hi
    # one extra tail word carrying bits pushed past the local capacity
    tail = jnp.where(r == 0, jnp.uint32(0),
                     words[-1] << jnp.where(r == 0, jnp.uint32(0),
                                            jnp.uint32(32) - r))
    out_words = jnp.concatenate([shifted, tail[None]])
    return out_words, offset // 32, local_bits, total_payload_bits


def _sharded_encode_core(mesh: Mesh, cfg, n: int, needs_model: bool):
    """shard_map-wrapped per-shard encode (shared by both programs)."""
    (axis,) = mesh.axis_names
    D = mesh.devices.size

    specs = (P(axis),) if not needs_model else (P(axis), P(axis))

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=specs,
        out_specs=(P(axis, None), P(axis), P(axis), P(axis)))
    def run(x_sh, model_sh=None):
        w, w0, lbits, tbits = _shard_encode(x_sh, model_sh, cfg, axis, D, n)
        return w[None], w0[None], lbits[None], tbits[None]

    return run


@functools.lru_cache(maxsize=64)
def _sharded_encode_program(mesh: Mesh, cfg, n: int, needs_model: bool):
    """Build (and cache) the jitted shard_map encode program."""
    return jax.jit(_sharded_encode_core(mesh, cfg, n, needs_model))


@functools.lru_cache(maxsize=64)
def _sp_frame_program(mesh: Mesh, cfg, n: int, needs_model: bool):
    """Jitted program producing the COMPLETE frame word stream on device.

    The whole frame is produced by one
    device program: shard encode -> scatter-merge of the shard spans onto
    the global word grid (overlapping boundary words carry disjoint bits,
    so the OR-merge is a scatter-add) -> closed-form device header words
    (ops/encode._header_words).  The only host steps left for a cs=0
    frame are the size fetch and the byte slice.

    Returns ``run(x, id_hi, id_lo, seq[, model]) -> (words, size_bytes,
    payload_bits)`` with ``words`` a worst-case-capacity u32 stream
    whose first ``ceil(size_bytes/4)`` words are the frame (trailing
    checksum bytes NOT included — XXH32 of one stream is bit-serial, the
    host splices it for cs=1 configs).
    """
    from ..ops.encode import _header_words, worst_case_words

    core = _sharded_encode_core(mesh, cfg, n, needs_model)
    W_cap = worst_case_words(cfg, n)

    @jax.jit
    def run(x, id_hi, id_lo, seq, model=None):
        if needs_model:
            words, starts, _lbits, tbits = core(x, model)
        else:
            words, starts, _lbits, tbits = core(x)
        payload_bits = tbits[0]
        bits = cfg.hdr_bits + payload_bits
        if cfg.checksum:
            total = bits + (-bits) % 8 + 32
        else:
            total = bits
        size = (total + 7) >> 3

        D_, Wl = words.shape
        # span merge: D contiguous spans at word offsets starts[d];
        # adjacent spans overlap in exactly one boundary word with
        # disjoint bits.  A fori of dynamic slice + OR + dynamic update
        # keeps every step a bulk contiguous copy.
        pad = jnp.zeros((Wl,), jnp.uint32)

        def merge(d, acc):
            seg = jax.lax.dynamic_slice(acc, (starts[d],), (Wl,))
            return jax.lax.dynamic_update_slice(
                acc, seg | words[d], (starts[d],))

        out = jax.lax.fori_loop(
            0, D_, merge, jnp.concatenate([jnp.zeros((W_cap,), jnp.uint32),
                                           pad]))[:W_cap]
        hdr = _header_words(cfg, size.astype(jnp.uint32), 2 * n,
                            jnp.asarray(id_hi, jnp.uint32),
                            jnp.asarray(id_lo, jnp.uint32),
                            jnp.asarray(seq, jnp.int32))
        # header words occupy the stream head; the last (half-filled, ext
        # case) header word shares its low bits with the payload start —
        # disjoint bit ranges, so add == or
        out = out.at[: len(hdr)].add(jnp.stack(hdr))
        return out, size, payload_bits

    return run


def compress_long_stream(mesh: Mesh, params: CmpParams, samples_u16,
                         identifier: int = 0, sequence_number: int = 0,
                         model=None, secondary: bool = False):
    """Compress ONE long u16 stream as a single AIRSPACE block, sharded.

    ``samples_u16`` length must divide evenly by the mesh size (and the
    per-shard length must be a power of two for IWT).  ``model`` supplies
    the model state for MODEL preprocessing (i16-valued array of the same
    length); ``secondary`` selects the pass parameters (cmp.c:228-248).
    Returns the complete frame bytes (bit-identical to the single-device
    encoder).  For chain semantics use :class:`LongStreamCompressor`.
    """
    params.validate()
    x_np = np.ascontiguousarray(np.asarray(samples_u16, dtype=np.uint16))
    n = x_np.size
    (axis,) = mesh.axis_names
    D = mesh.devices.size
    if n % D:
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       f"stream length {n} not divisible by mesh size {D}")
    if 2 * n > (1 << 24) - 1:
        raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
    cfg = make_pass_config(params, secondary, True)
    if cfg.prep == int(Preprocessing.IWT):
        L = n // D
        if L & (L - 1):
            raise CmpError(
                CmpErrorCode.SRC_SIZE_WRONG,
                f"IWT long-stream mode needs a power-of-two shard length, "
                f"got {n}/{D}={L}")
    needs_model = cfg.prep == int(Preprocessing.MODEL)
    if needs_model and model is None:
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "MODEL preprocessing requires model state")

    x = jnp.asarray(x_np.view(np.int16), jnp.int32)
    id_hi = (identifier >> 24) & 0xFFFFFF
    id_lo = identifier & 0xFFFFFF
    m = (jnp.asarray(np.asarray(model, np.int16), jnp.int32)
         if needs_model else None)
    run = _sp_frame_program(mesh, cfg, n, needs_model)
    args = (x, id_hi, id_lo, sequence_number) + ((m,) if needs_model else ())
    out_words, size_dev, _pb = run(*args)

    # the device program produced the complete frame (header included);
    # host work is the size fetch + byte slice (+ checksum splice: XXH32
    # of ONE stream is bit-serial, so it stays a host-streamed pass)
    size = int(size_dev)
    frame = bytearray(
        np.asarray(out_words[: (size + 3) // 4]).astype(">u4")
        .tobytes()[:size])
    if cfg.checksum:
        # shard-chunked streaming checksum: only 16 bytes of state cross
        # shard boundaries (multi-host: a D-hop relay, no full gather)
        csum = cmp_checksum_chunked(x_np.reshape(D, -1))
        frame[size - 4 : size] = csum.to_bytes(4, "big")
    return bytes(frame)


# -- parallel decode of ONE long block (sidecar-indexed) -------------------
#
# Golomb decoding is bit-serial: inside a single AIRSPACE block there is
# no format-level sync point, so a huge block decodes host-serially in
# principle (the price of the format, SURVEY §7.1).  This buys the
# parallelism back OUTSIDE the format: a sidecar of per-chunk payload bit
# lengths (4 bytes per 1024 samples ≈ 0.2% of the data) lets every chunk
# start its cursor independently — the stream becomes a batch of chunk
# lanes for the SAME lockstep decoder used for block batches.  The
# frame stays format-pure; the sidecar is derivable from the samples (or
# from one sequential decode) and is validated on use: every lane's end
# position must land exactly on its chunk boundary.


@functools.partial(jax.jit, static_argnames=("cfg", "chunk"))
def _chunk_bits_device(cfg, x, chunk: int, model=None):
    """Device core of the sidecar build: per-chunk payload bit sums."""
    from ..ops.preprocess import preprocess_forward

    res = preprocess_forward(cfg.prep, x, model)[0]
    _, _, lens = golomb.encode_codewords(res, cfg.enc_type, cfg.g_par,
                                         cfg.outlier)
    # int32 is ample: a chunk's bits <= chunk * 48 < 2^31
    return jnp.sum(lens.reshape(-1, chunk), axis=-1).astype(jnp.int32)


def stream_chunk_index(params: CmpParams, samples_u16,
                       chunk_samples: int = 1024, secondary: bool = False,
                       model=None) -> np.ndarray:
    """Per-chunk payload bit lengths for one long block (the sidecar).

    Computed from the samples with one cheap device pass (preprocess +
    closed-form codeword lengths + chunk sums) — no packing, no decode.
    This recomputes lengths the encoder also derives internally, a
    deliberate trade: the codeword-length pass is cheap next to the
    pack, and keeping it standalone leaves the sharded encode program —
    and its compile cache — untouched, and also lets a sidecar be built
    for a stream whose frame came from anywhere (e.g. the host codec).
    """
    cfg = make_pass_config(params, secondary, True)
    if cfg.enc_type not in (1, 2):
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "chunk index applies to Golomb-coded blocks")
    if cfg.prep == int(Preprocessing.MODEL) and model is None:
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "MODEL preprocessing requires model state")
    x_np = np.ascontiguousarray(np.asarray(samples_u16, dtype=np.uint16))
    n = x_np.size
    if n % chunk_samples:
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       f"stream length {n} not divisible by chunk "
                       f"{chunk_samples}")
    x = jnp.asarray(x_np.view(np.int16), jnp.int32)[None]
    m = (jnp.asarray(np.asarray(model, np.int16), jnp.int32)[None]
         if model is not None else None)
    return np.asarray(_chunk_bits_device(cfg, x, chunk_samples, m))


@functools.partial(jax.jit, static_argnames=("dcfg", "chunk", "c_lane",
                                             "prep", "n"))
def _sidecar_decode_device(dcfg, words, start, chunk: int, c_lane: int,
                           prep: int, n: int, model=None):
    """Device core of the sidecar decode: window gather -> lockstep
    decode -> inverse preprocess.  One jitted program (the unit the
    bench times); returns ((n,) samples, (n_chunks,) end bit positions).
    """
    from ..ops.decode import decode_blocks_device
    from ..ops.preprocess import preprocess_inverse

    W = words.shape[0]
    n_chunks = start.shape[0]
    base = start >> 5
    r = (start & 31).astype(jnp.uint32)[:, None]
    # Window build as a ROW-granular gather: the stream reshaped into
    # 128-word rows, each chunk takes its aligned row run (an
    # embedding-style whole-row gather), then a 7-level word barrel
    # shift aligns the window.  Zero row padding gives zero-fill past
    # the stream end.
    row = 128
    n_rows = (c_lane + row - 1) // row + 1
    pad = (-W) % row + (n_rows + 1) * row
    tbl = jnp.concatenate(
        [words, jnp.zeros((pad,), jnp.uint32)]).reshape(-1, row)
    ridx = (base >> 7)[:, None] + jnp.arange(n_rows, dtype=jnp.int32)
    ext = jnp.take(tbl, ridx.reshape(-1), axis=0).reshape(
        n_chunks, n_rows * row)
    woff = base & (row - 1)
    for t in range(7):  # word-align: shift left by (base mod 128) words
        s = 1 << t
        sh = jnp.concatenate(
            [ext[:, s:], jnp.zeros((n_chunks, s), jnp.uint32)], axis=1)
        ext = jnp.where((((woff >> t) & 1) == 1)[:, None], sh, ext)
    win = ext[:, :c_lane]
    nxt = jnp.concatenate(
        [win[:, 1:], jnp.zeros((n_chunks, 1), jnp.uint32)], axis=-1)
    win = jnp.where(r == 0, win,
                    (win << r) | ((nxt >> jnp.uint32(1))
                                  >> (jnp.uint32(31) - r)))
    residuals, end = decode_blocks_device(
        dcfg, win, jnp.zeros((n_chunks, chunk), jnp.int32), chunk)
    if prep == int(Preprocessing.DIFF):
        # blocked wraparound cumsum: per-chunk cumsums (lane-parallel)
        # plus exclusive chunk offsets — exact because mod-2^16 addition
        # is associative, and far faster than one 2^21-element cumsum
        within = jnp.cumsum(residuals, axis=-1, dtype=jnp.int32)
        rows = within[:, -1]
        offs = jnp.cumsum(rows, dtype=jnp.int32) - rows
        samples = wrap16(within + offs[:, None]).reshape(1, n)
    else:
        samples = preprocess_inverse(prep, residuals.reshape(1, n), model)
    return samples[0], end


def decompress_long_stream(frame: bytes, chunk_bits, model=None,
                           verify_checksum: bool = True):
    """Decode ONE long Golomb block chunk-parallel on device.

    ``chunk_bits`` is the sidecar from :func:`stream_chunk_index` (per-
    chunk payload bit lengths).  Each chunk's 32-bit-word window is
    gathered from the stream and funnel-shifted so its first codeword
    sits exactly where the lockstep decoder expects a block's payload —
    the kernel itself is unchanged.  Integrity: every lane's decode end
    position must land exactly on its chunk boundary (a wrong/corrupt
    sidecar or payload raises INT_BITSTREAM), and the trailing XXH32 is
    verified when present.  Returns the uint16 samples.
    """
    from ..format.header import CMP_HDR_MAX_SIZE
    from ..ops.encode import PassConfig
    from ..utils.xxh32 import cmp_checksum

    hdr, hsz = CmpHeader.deserialize(frame[:CMP_HDR_MAX_SIZE])
    if hdr.preprocessing > 3:
        raise CmpError(CmpErrorCode.INT_HDR,
                       f"unknown preprocessing {hdr.preprocessing}")
    if hdr.encoder_type not in (1, 2):
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "sidecar decode applies to Golomb-coded blocks")
    if not (1 <= hdr.encoder_param <= 0xFFFF):
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "bad Golomb parameter in header")
    if hdr.compressed_size > len(frame):
        raise CmpError(CmpErrorCode.INT_HDR, "truncated frame")
    n = hdr.original_size // 2
    chunk_bits = np.asarray(chunk_bits, np.int64)
    n_chunks = chunk_bits.size
    if n_chunks == 0 or n % n_chunks:
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       "chunk index does not tile the stream")
    chunk = n // n_chunks

    dcfg = PassConfig(0, hdr.encoder_type, hdr.encoder_param,
                      hdr.encoder_outlier, bool(hdr.checksum_enabled),
                      0, False, True)
    hb = dcfg.hdr_bits  # 176: ext present (encoder != NONE)

    padded = frame + b"\x00" * ((-len(frame)) % 4)
    words = jnp.asarray(
        np.frombuffer(padded, dtype=">u4").astype(np.uint32))

    # absolute payload bit offset of each chunk; window starts hb bits
    # earlier so the decoder's header skip lands on the first codeword
    off = hsz * 8 + np.concatenate(([0], np.cumsum(chunk_bits)[:-1]))
    if (off[-1] + chunk_bits[-1] + 7) // 8 > hdr.compressed_size:
        raise CmpError(CmpErrorCode.INT_BITSTREAM,
                       "chunk index exceeds compressed_size")
    start = jnp.asarray(off - hb, jnp.int32)
    # window sized by the LARGEST actual chunk (the sidecar is exact),
    # not the worst case — a lying sidecar is safe either way: short
    # windows zero-fill and the end-boundary check below rejects them
    max_bits = min(int(chunk_bits.max()),
                   chunk * dcfg.worst_bits_per_sample)
    c_lane = (hb + max_bits + 63) // 32 + 2

    if hdr.preprocessing == int(Preprocessing.MODEL):
        if model is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "MODEL preprocessing requires model state")
        m = jnp.asarray(np.asarray(model, np.int16), jnp.int32)[None]
    else:
        m = None
    samples, end = _sidecar_decode_device(
        dcfg, words, start, chunk, c_lane, hdr.preprocessing, n, m)
    end_np = np.asarray(end, np.int64)
    if not np.array_equal(end_np, hb + chunk_bits):
        raise CmpError(CmpErrorCode.INT_BITSTREAM,
                       "chunk decode did not land on its boundary "
                       "(corrupt payload or sidecar)")
    out = np.asarray(samples).astype(np.int32).astype(np.uint16)
    if verify_checksum and hdr.checksum_enabled:
        stored = int.from_bytes(
            frame[hdr.compressed_size - 4 : hdr.compressed_size], "big")
        if cmp_checksum(out) != stored:
            raise CmpError(CmpErrorCode.GENERIC, "checksum mismatch")
    return out


# -- streaming (chunk-fed) encode of ONE long block ------------------------
#
# compress_long_stream is one-shot: the whole stream must be resident
# before the program runs, so a long acquisition pays transfer and
# compute serially.  This tier encodes the SAME
# single AIRSPACE block chunk by chunk with a device-resident carry (bit
# offset, previous sample, output words), so chunk k+1's upload overlaps
# chunk k's encode on real hardware and the stream never needs to exist
# in one piece on any host.


def _shard_residuals_chunk(cfg, x_loc, model_loc, axis, D, prev_last,
                           first):
    """Per-shard preprocessing of one CHUNK with a cross-chunk carry.

    NONE and MODEL are elementwise (bit-identical to the one-shot path);
    DIFF takes the previous chunk's global last sample as the first
    shard's left halo, and stores the very first sample of the STREAM
    raw only on the first chunk (``first`` traced).  IWT lifts across
    the whole stream at every level, so it cannot stream — rejected at
    program-build time.
    """
    if cfg.prep == int(Preprocessing.NONE):
        return x_loc
    if cfg.prep == int(Preprocessing.MODEL):
        return model_forward(x_loc, model_loc)
    if cfg.prep == int(Preprocessing.DIFF):
        d = jax.lax.axis_index(axis)
        ring_prev = _halo_from_left(x_loc[-1:], axis, D)[0]
        prev0 = jnp.where(d == 0, prev_last, ring_prev)
        prev = jnp.concatenate([prev0[None], x_loc[:-1]])
        res = wrap16(x_loc - prev)
        raw0 = first & (d == 0) & (jnp.arange(x_loc.shape[0]) == 0)
        return jnp.where(raw0, wrap16(x_loc), res)
    raise CmpError(CmpErrorCode.PARAMS_INVALID,
                   "streaming long-stream encode supports NONE/DIFF/MODEL")


def _shard_encode_chunk(x_loc, model_loc, cfg, axis, D, base_bits,
                        prev_last, first):
    """Chunk variant of :func:`_shard_encode`: the absolute payload bit
    offset continues from the traced cross-chunk carry ``base_bits``."""
    d = jax.lax.axis_index(axis)
    res = _shard_residuals_chunk(cfg, x_loc, model_loc, axis, D, prev_last,
                                 first)
    hi, lo, lens = golomb.encode_codewords(res, cfg.enc_type, cfg.g_par,
                                           cfg.outlier)
    n_loc = lens.shape[-1]
    K = 1 << (n_loc - 1).bit_length() if n_loc > 1 else 1
    if K != n_loc:
        pad = jnp.zeros((K - n_loc,), jnp.uint32)
        hi = jnp.concatenate([hi, pad])
        lo = jnp.concatenate([lo, pad])
        lens = jnp.concatenate([lens, jnp.zeros((K - n_loc,), jnp.int32)])
    local_bits = jnp.sum(lens)
    all_bits = jax.lax.all_gather(local_bits, axis)  # (D,)
    before = jnp.sum(jnp.where(jnp.arange(all_bits.shape[0]) < d, all_bits,
                               0))
    offset = base_bits + before
    total_chunk_bits = jnp.sum(all_bits)

    words, _ = bitpack.pack_codes_tree(hi, lo, lens,
                                       cfg.worst_bits_per_sample)
    r = (offset % 32).astype(jnp.uint32)
    wprev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), words[:-1]])
    shift_hi = jnp.where(r == 0, jnp.uint32(0),
                         wprev << jnp.where(r == 0, jnp.uint32(0),
                                            jnp.uint32(32) - r))
    shifted = (words >> r) | shift_hi
    tail = jnp.where(r == 0, jnp.uint32(0),
                     words[-1] << jnp.where(r == 0, jnp.uint32(0),
                                            jnp.uint32(32) - r))
    out_words = jnp.concatenate([shifted, tail[None]])
    return out_words, offset // 32, local_bits, total_chunk_bits


@functools.lru_cache(maxsize=64)
def _sp_chunk_program(mesh: Mesh, cfg, chunk_n: int, needs_model: bool):
    """Jitted per-chunk step of the streaming long-stream encoder.

    ``run(out, carry_bits, prev_last, first, x[, model]) -> (out',
    carry', prev')``: encodes one chunk, OR-merges its word spans into
    the accumulating frame buffer ``out`` at the carried bit offset, and
    returns the advanced carry.  Everything stays on device; no host
    sync inside.
    """
    (axis,) = mesh.axis_names
    D = mesh.devices.size
    specs = [P(axis)]
    if needs_model:
        specs.append(P(axis))
    specs += [P(), P(), P()]

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=tuple(specs),
        out_specs=(P(axis, None), P(axis), P(axis), P(axis)),
        check_vma=False)
    def enc(x_sh, *rest):
        if needs_model:
            model_sh, base, prev, first = rest
        else:
            (base, prev, first), model_sh = rest, None
        w, w0, lbits, tbits = _shard_encode_chunk(
            x_sh, model_sh, cfg, axis, D, base, prev, first)
        return w[None], w0[None], lbits[None], tbits[None]

    @jax.jit
    def run(out, carry_bits, prev_last, first, x, model=None):
        args = (x, model) if needs_model else (x,)
        words, starts, _lbits, tbits = enc(*args, carry_bits, prev_last,
                                           first)
        D_, Wl = words.shape

        def merge(d, acc):
            seg = jax.lax.dynamic_slice(acc, (starts[d],), (Wl,))
            return jax.lax.dynamic_update_slice(
                acc, seg | words[d], (starts[d],))

        out2 = jax.lax.fori_loop(0, D_, merge, out)
        return out2, carry_bits + tbits[0], x[-1]

    return run


@functools.lru_cache(maxsize=64)
def _sp_feed_many_program(mesh: Mesh, cfg, chunk_n: int, k_chunks: int,
                          needs_model: bool):
    """K-chunk streaming step in ONE dispatch (a fori over the chunk
    step INSIDE the program).

    Python-dispatch cost is per call, not per chunk, so a producer can
    keep its natural (small) chunk size while the encoder amortizes the
    launch over ``k_chunks`` — the difference between a dispatch-bound
    and a compute-bound streaming tier.  One shard_map wraps the whole
    loop: per chunk the shards encode + pack locally, all_gather the
    packed spans (replicated merge keeps ``out`` identical everywhere),
    and carry (bit offset, previous sample) flows through the fori
    state.  Same contract as :func:`_sp_chunk_program` otherwise.
    """
    (axis,) = mesh.axis_names
    D = mesh.devices.size
    specs = [P(), P(), P(), P(), P(None, axis)]
    if needs_model:
        specs.append(P(None, axis))

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=tuple(specs),
        out_specs=(P(), P(), P()), check_vma=False)
    def run_sh(out, carry_bits, prev_last, first, xs_sh, model_sh=None):
        def body(k, st):
            acc, base, prev = st
            x_loc = xs_sh[k]
            m_loc = model_sh[k] if needs_model else None
            w, w0, _lbits, tbits = _shard_encode_chunk(
                x_loc, m_loc, cfg, axis, D, base, prev, first & (k == 0))
            words_all = jax.lax.all_gather(w, axis)    # (D, Wl)
            starts_all = jax.lax.all_gather(w0, axis)  # (D,)
            Wl = w.shape[0]

            def merge(d, a):
                seg = jax.lax.dynamic_slice(a, (starts_all[d],), (Wl,))
                return jax.lax.dynamic_update_slice(
                    a, seg | words_all[d], (starts_all[d],))

            acc2 = jax.lax.fori_loop(0, D, merge, acc)
            prev2 = jax.lax.all_gather(x_loc[-1], axis)[-1]
            return acc2, base + tbits, prev2

        return jax.lax.fori_loop(0, k_chunks, body,
                                 (out, carry_bits, prev_last))

    return jax.jit(run_sh)


class ChunkedLongStreamEncoder:
    """Encode ONE long AIRSPACE block from a stream of sample chunks.

    Produces bytes IDENTICAL to ``compress_long_stream`` over the
    concatenated chunks (asserted by tests), but the samples arrive in
    ``chunk_samples``-sized pieces: each :meth:`feed` runs one
    device-resident step (upload chunk -> shard encode -> funnel shift
    onto the carried global bit grid -> span merge into the accumulating
    frame buffer), so on real hardware chunk k+1's host->device transfer
    overlaps chunk k's encode, and no host ever holds the whole stream.
    The XXH32 trailer streams through the 16-byte host state
    (utils/xxh32.XXH32State) chunk by chunk.  The feed loop is entirely
    sync-free (pure enqueue).

    :meth:`feed_many` consumes a whole (K, chunk) buffer of chunks in
    ONE device dispatch (the per-chunk step runs in a fori loop inside
    the program), decoupling the producer's chunk size from the launch
    granularity — use it whenever more than one chunk is available at a
    time; per-chunk Python dispatch otherwise bounds throughput.

    Preprocessing NONE/DIFF/MODEL stream exactly (DIFF carries one
    sample across chunks); IWT lifts across the whole stream at every
    level and is rejected (use ``compress_long_stream``).
    """

    def __init__(self, mesh: Mesh, params: CmpParams, total_samples: int,
                 chunk_samples: int, identifier: int = 0,
                 sequence_number: int = 0, secondary: bool = False):
        params.validate()
        self.mesh = mesh
        self.params = params
        cfg = make_pass_config(params, secondary, True)
        if cfg.prep == int(Preprocessing.IWT):
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "IWT cannot stream; use compress_long_stream")
        D = mesh.devices.size
        if chunk_samples % D or total_samples % chunk_samples:
            raise CmpError(
                CmpErrorCode.SRC_SIZE_WRONG,
                f"chunk {chunk_samples} must divide the stream "
                f"{total_samples} and shard evenly over {D} devices")
        if 2 * total_samples > (1 << 24) - 1:
            raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
        self.cfg = cfg
        self.total = total_samples
        self.chunk = chunk_samples
        self.identifier = identifier
        self.sequence_number = sequence_number
        self._needs_model = cfg.prep == int(Preprocessing.MODEL)
        from ..ops.encode import worst_case_words

        wb = cfg.worst_bits_per_sample
        # merge slack past the worst-case frame: the last chunk's spans
        # (shard payload + tail word) must stay in dynamic-slice bounds
        slack = (chunk_samples // D * wb) // 32 + 8
        w_cap = worst_case_words(cfg, total_samples)
        self._out = jnp.zeros((w_cap + slack,), jnp.uint32)
        self._carry = jnp.asarray(cfg.hdr_bits, jnp.int32)
        self._prev = jnp.asarray(0, jnp.int32)
        self._first = jnp.asarray(True)
        self._csum = None
        if cfg.checksum:
            from ..utils.xxh32 import CHECKSUM_SEED, XXH32State

            self._csum = XXH32State(CHECKSUM_SEED)
        self._fed = 0

    def _run(self, many, *args):
        if many:
            prog = _sp_feed_many_program(self.mesh, self.cfg, self.chunk,
                                         args[4].shape[0],
                                         self._needs_model)
        else:
            prog = _sp_chunk_program(self.mesh, self.cfg, self.chunk,
                                     self._needs_model)
        self._out, self._carry, self._prev = prog(*args)
        self._first = jnp.asarray(False)

    def feed(self, chunk_u16, model_chunk=None) -> None:
        """Feed the next ``chunk_samples`` samples.

        Accepts host u16 arrays (uploaded here) or device-resident
        arrays (u16-valued int32/uint32 — used zero-copy, so a producer
        whose samples are already on device never routes them through
        the host; with the checksum enabled the sample bytes are still
        needed host-side for the streaming XXH32 state, costing one
        fetch per chunk in that combination).
        """
        if isinstance(chunk_u16, jax.Array):
            if chunk_u16.size != self.chunk:
                raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                               f"expected {self.chunk}-sample chunks")
            # sign-extend the 16-bit values like the host path's i16 view
            v = chunk_u16.astype(jnp.int32) & 0xFFFF
            x = ((v ^ 0x8000) - 0x8000).astype(jnp.int32)
            x_np = None
        else:
            x_np = np.ascontiguousarray(np.asarray(chunk_u16, np.uint16))
            if x_np.size != self.chunk:
                raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                               f"expected {self.chunk}-sample chunks")
            x = jnp.asarray(x_np.view(np.int16), jnp.int32)
        if self._fed + self.chunk > self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG, "stream overfed")
        if self._needs_model and model_chunk is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "MODEL preprocessing requires model chunks")
        operands = (x,)
        if self._needs_model:
            operands += (jnp.asarray(
                np.asarray(model_chunk, np.int16), jnp.int32),)
        self._run(False, self._out, self._carry, self._prev, self._first,
                  *operands)
        if self._csum is not None:
            if x_np is None:
                x_np = np.asarray(x).astype(np.uint16)
            self._csum.update(x_np.astype(">u2").tobytes())
        self._fed += self.chunk

    def feed_many(self, chunks, model_chunks=None) -> None:
        """Feed K chunks — a (K, chunk_samples) buffer — in ONE dispatch.

        Same semantics as K sequential :meth:`feed` calls at a fraction
        of the launch cost (the per-chunk step runs in a fori loop
        inside the program); accepts host u16 or device-resident arrays
        like :meth:`feed`.
        """
        if isinstance(chunks, jax.Array):
            v = chunks.astype(jnp.int32) & 0xFFFF
            xs = ((v ^ 0x8000) - 0x8000).astype(jnp.int32)
            xs_np = None
        else:
            xs_np = np.ascontiguousarray(np.asarray(chunks, np.uint16))
            xs = jnp.asarray(xs_np.view(np.int16), jnp.int32)
        if xs.ndim != 2 or xs.shape[1] != self.chunk:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"expected (K, {self.chunk}) chunk buffers")
        k = xs.shape[0]
        if self._fed + k * self.chunk > self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG, "stream overfed")
        if self._needs_model and model_chunks is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "MODEL preprocessing requires model chunks")
        operands = (xs,)
        if self._needs_model:
            operands += (jnp.asarray(
                np.asarray(model_chunks, np.int16), jnp.int32),)
        self._run(True, self._out, self._carry, self._prev, self._first,
                  *operands)
        if self._csum is not None:
            if xs_np is None:
                xs_np = np.asarray(xs).astype(np.uint16)
            self._csum.update(xs_np.astype(">u2").tobytes())
        self._fed += k * self.chunk

    def finish(self) -> bytes:
        """Assemble and return the complete frame bytes."""
        if self._fed != self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"fed {self._fed} of {self.total} samples")
        bits = int(np.asarray(self._carry))
        if self.cfg.checksum:
            total_bits = bits + (-bits) % 8 + 32
        else:
            total_bits = bits
        size = (total_bits + 7) >> 3
        words = np.asarray(self._out[: (size + 3) // 4])
        frame = bytearray(words.astype(">u4").tobytes()[:size])
        hdr = CmpHeader(
            compressed_size=size, original_size=2 * self.total,
            identifier=self.identifier,
            sequence_number=self.sequence_number,
            preprocessing=self.cfg.prep,
            checksum_enabled=1 if self.cfg.checksum else 0,
            encoder_type=self.cfg.enc_type,
            model_rate=(self.params.model_rate
                        if self.cfg.prep == int(Preprocessing.MODEL) else 0),
            encoder_param=self.cfg.g_par if self.cfg.enc_type else 0,
            encoder_outlier=self.cfg.outlier if self.cfg.enc_type else 0)
        hb = hdr.serialize()
        frame[: len(hb)] = hb  # header is whole bytes (16 or 22)
        if self._csum is not None:
            frame[size - 4: size] = self._csum.intdigest().to_bytes(4, "big")
        return bytes(frame)


class LongStreamCompressor:
    """Multi-pass chain over long sharded streams (one reference context).

    Mirrors the engine's pass-selection / fallback / model-update
    semantics (cmp.c:213-393) for a single block chain whose samples are
    stream-sharded over ``mesh``:

    * pass selection: seq 0 (or exhausted secondary iterations) runs the
      primary parameters and reseeds the model with the frame;
    * the uncompressed fallback triggers exactly when the compressed frame
      exceeds the uncompressed frame size, resets the chain, and draws two
      fresh identifiers (cmp.c:380-392 side effects);
    * the model EMA update (cmp.c:120-129) is elementwise — it shards with
      the stream and is carried as host state between calls here.
    """

    def __init__(self, mesh: Mesh, params: CmpParams):
        params.validate()
        self.mesh = mesh
        self.params = params
        self.seq = 0
        self.identifier = 0
        self.model: np.ndarray | None = None
        self._n: int | None = None
        # reference cmp_initialise ends in cmp_reset, which draws an
        # identifier (cmp.c:203-208, :452-465); every primary-pass engine
        # reset then draws another
        self.reset()

    def reset(self) -> None:
        from ..engine import context as _context

        self.seq = 0
        self.identifier = _context._new_identifier()

    def compress(self, samples_u16) -> bytes:
        from ..engine import context as _context

        x_np = np.ascontiguousarray(np.asarray(samples_u16, dtype=np.uint16))
        primary = (self.seq == 0
                   or self.seq > self.params.secondary_iterations)
        if primary:
            self.reset()
        elif self.params.model_is_needed() and x_np.size != self._n:
            raise CmpError(CmpErrorCode.SRC_SIZE_MISMATCH)
        secondary = not primary
        cfg = make_pass_config(self.params, secondary, True)
        model_in = self.model if cfg.prep == int(Preprocessing.MODEL) else None
        frame = compress_long_stream(self.mesh, self.params, x_np,
                                     identifier=self.identifier,
                                     sequence_number=self.seq,
                                     model=model_in, secondary=secondary)

        unc_size = CMP_HDR_SIZE + 2 * x_np.size \
            + (4 if self.params.checksum_enabled else 0)
        if (self.params.uncompressed_fallback_enabled
                and len(frame) > unc_size):
            # reference fallback: generic reset + engine reset draw two
            # fresh identifiers; frame becomes NONE + UNCOMPRESSED at seq 0
            for _ in range(2):
                self.identifier = _context._new_identifier()
            import dataclasses as _dc

            fb_params = _dc.replace(
                self.params,
                primary_preprocessing=Preprocessing.NONE,
                primary_encoder_type=EncoderType.UNCOMPRESSED)
            frame = compress_long_stream(self.mesh, fb_params, x_np,
                                         identifier=self.identifier,
                                         sequence_number=0)
            self.model = x_np.view(np.int16).copy()
            self._n = x_np.size
            self.seq = 1
            return frame

        if self.params.model_is_needed():
            if self.seq == 0:
                self.model = x_np.view(np.int16).copy()
            else:
                upd = model_update(
                    jnp.asarray(x_np.view(np.int16), jnp.int32),
                    jnp.asarray(self.model, jnp.int32),
                    jnp.asarray(self.params.model_rate, jnp.int32),
                    unsigned=True)
                self.model = np.asarray(upd, np.int32).astype(np.int16)
            self._n = x_np.size
        self.seq += 1
        return frame
