"""Device (JAX) encoder parity vs the host codec (itself oracle-verified).

Runs on CPU-backed JAX (conftest pins the platform).  Frames produced by
the batched device pipeline must byte-match per-block host contexts for
every config, modulo the 48-bit timestamp identifier (bytes 8..14), whose
draw order necessarily differs between B sequential contexts and one
batched call; identifier semantics are covered by the oracle parity tests.
"""

import numpy as np
import pytest

from airs_compression_tpu import (
    CmpContext,
    CmpParams,
    EncoderType,
    Preprocessing,
    decompress,
)
from airs_compression_tpu.format.dtypes import CmpType
from airs_compression_tpu.models.stream import BatchCompressor
from airs_compression_tpu.ops import bitpack, golomb, preprocess

import jax.numpy as jnp


def _mask_id(frame: bytes) -> bytes:
    b = bytearray(frame)
    b[8:14] = b"\x00" * 6
    return bytes(b)


CONFIGS = [
    CmpParams(),
    CmpParams(checksum_enabled=True),
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=1),
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=7, checksum_enabled=True),
    CmpParams(primary_preprocessing=Preprocessing.IWT,
              primary_encoder_type=EncoderType.GOLOMB_MULTI,
              primary_encoder_param=5, primary_encoder_outlier=80),
    CmpParams(primary_preprocessing=Preprocessing.NONE,
              primary_encoder_type=EncoderType.GOLOMB_MULTI,
              primary_encoder_param=0xFFFF,
              primary_encoder_outlier=0xFFFFFFFF),
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=2,
              secondary_iterations=4,
              secondary_preprocessing=Preprocessing.MODEL,
              secondary_encoder_type=EncoderType.GOLOMB_MULTI,
              secondary_encoder_param=3, secondary_encoder_outlier=60,
              model_rate=10, checksum_enabled=True),
    CmpParams(primary_preprocessing=Preprocessing.IWT,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=3,
              uncompressed_fallback_enabled=True),
]


class TestOps:
    def test_zigzag_roundtrip(self):
        v = jnp.asarray(np.arange(-32768, 32768, 7, dtype=np.int32))
        m = golomb.zigzag(v)
        back = golomb.unzigzag(m)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(v))

    def test_ilog2(self):
        x = np.arange(1, 1 << 16, 13, dtype=np.uint32)
        got = np.asarray(golomb.ilog2(jnp.asarray(x)))
        exp = np.floor(np.log2(x)).astype(np.uint32)
        np.testing.assert_array_equal(got, exp)

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 64, 100, 257])
    def test_iwt_device_matches_host(self, n):
        from airs_compression_tpu.engine import host

        rng = np.random.default_rng(n)
        x = rng.integers(-32768, 32768, (4, n)).astype(np.int16)
        dev = np.asarray(preprocess.iwt_forward(jnp.asarray(x, jnp.int32)))
        for b in range(4):
            np.testing.assert_array_equal(
                dev[b].astype(np.int16), host.iwt_forward(x[b]),
                err_msg=f"n={n} block {b}")
        inv = np.asarray(preprocess.iwt_inverse(jnp.asarray(dev)))
        np.testing.assert_array_equal(inv.astype(np.int16), x)

    def test_pack_codes_simple(self):
        # bytes 0x00..0x09 as five 16-bit codes (test_encoder.c:67-88)
        lo = jnp.asarray([0x0001, 0x0203, 0x0405, 0x0607, 0x0809], jnp.uint32)
        hi = jnp.zeros_like(lo)
        lens = jnp.full((5,), 16, jnp.int32)
        words, total = bitpack.pack_codes(hi, lo, lens, 4)
        assert int(total) == 80
        got = np.asarray(words).astype(">u4").tobytes()[:10]
        assert got == bytes(range(10))

    def test_pack_codes_unaligned(self):
        # 1,3,48,7,12-bit codes crossing word boundaries
        codes = [(0, 1, 1), (0, 0b101, 3), (0xABCD, 0x12345678, 48),
                 (0, 0x55, 7), (0, 0xFFF, 12)]
        hi = jnp.asarray([c[0] for c in codes], jnp.uint32)
        lo = jnp.asarray([c[1] for c in codes], jnp.uint32)
        ln = jnp.asarray([c[2] for c in codes], jnp.int32)
        words, total = bitpack.pack_codes(hi, lo, ln, 4)
        # reference via python big-int
        acc, bits = 0, 0
        for chi, clo, cl in codes:
            acc = (acc << cl) | (((chi << 32) | clo) & ((1 << cl) - 1))
            bits += cl
        assert int(total) == bits
        acc <<= (-bits) % 32
        exp = acc.to_bytes(((bits + 31) // 32) * 4, "big")
        got = np.asarray(words).astype(">u4").tobytes()[: len(exp)]
        assert got == exp


class TestDeviceVsHost:
    @pytest.mark.parametrize("cfg_i", range(len(CONFIGS)))
    @pytest.mark.parametrize("n", [5, 333])
    def test_batch_matches_host(self, cfg_i, n):
        params = CONFIGS[cfg_i]
        B = 4
        rng = np.random.default_rng(100 * cfg_i + n)
        bc = BatchCompressor(params, B, n)
        hosts = [CmpContext(params) for _ in range(B)]
        for frame_i in range(4 if params.secondary_iterations else 2):
            if cfg_i == 7 and frame_i % 2 == 0:
                frames = rng.integers(0, 65536, (B, n)).astype(np.uint16)
            else:
                frames = (1100 + rng.normal(0, 6, (B, n))).astype(np.int64)
                frames = (frames & 0xFFFF).astype(np.uint16)
            dev_frames = bc.compress_frames(frames)
            for b in range(B):
                host_frame = hosts[b].compress_u16(frames[b])
                assert _mask_id(dev_frames[b]) == _mask_id(host_frame), (
                    f"cfg {cfg_i} n={n} frame {frame_i} block {b}")

    def test_device_stream_decodes(self):
        params = CONFIGS[6]
        B, n = 3, 256
        rng = np.random.default_rng(0)
        bc = BatchCompressor(params, B, n)
        per_chain = [b"" for _ in range(B)]
        all_frames = [[] for _ in range(B)]
        for _ in range(6):
            frames = ((1000 + rng.normal(0, 5, (B, n))).astype(np.int64)
                      & 0xFFFF).astype(np.uint16)
            outs = bc.compress_frames(frames)
            for b in range(B):
                per_chain[b] += outs[b]
                all_frames[b].append(frames[b])
        for b in range(B):
            dec, hdrs = decompress(per_chain[b], CmpType.U16)
            np.testing.assert_array_equal(dec, np.concatenate(all_frames[b]))
            assert [h.sequence_number for h in hdrs] == [0, 1, 2, 3, 4, 0]

    def test_mixed_phase_batch(self):
        """Chains at different sequence positions in one batch."""
        params = CONFIGS[6]
        B, n = 4, 128
        rng = np.random.default_rng(1)
        bc = BatchCompressor(params, B, n)
        # desynchronize: manually reset one chain's sequence mid-stream
        frames0 = ((1000 + rng.normal(0, 5, (B, n))).astype(np.int64)
                   & 0xFFFF).astype(np.uint16)
        bc.compress_frames(frames0)
        bc.seq[2] = 0  # force chain 2 back to primary
        frames1 = ((1000 + rng.normal(0, 5, (B, n))).astype(np.int64)
                   & 0xFFFF).astype(np.uint16)
        outs = bc.compress_frames(frames1)
        from airs_compression_tpu import CmpHeader

        hdrs = [CmpHeader.deserialize(o)[0] for o in outs]
        assert [h.sequence_number for h in hdrs] == [1, 1, 0, 1]
        assert hdrs[2].preprocessing == int(Preprocessing.DIFF)
        assert hdrs[0].preprocessing == int(Preprocessing.MODEL)


class TestClampedOkContract:
    """The clamped-buffer ``ok`` flag must be honest on EVERY packer path.

    ``_assemble_frames`` truncates frames at ``n_words``; with an
    entropy-clamped buffer the XLA tree packer has no overflow detector,
    so ok must be derived from the exact frame size.
    """

    def _cfg(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1)
        from airs_compression_tpu.ops.encode import make_pass_config

        return params, make_pass_config(params, False, True)

    def test_xla_path_flags_oversized_frames(self):
        from airs_compression_tpu.ops.encode import (
            clamped_frame_words,
            encode_blocks_device,
            worst_case_words,
        )

        params, cfg = self._cfg()
        B, N, cap = 4, 256, 8
        rng = np.random.default_rng(0)
        x_np = np.empty((B, N), np.uint16)
        x_np[:2] = rng.integers(0, 1 << 16, (2, N))       # incompressible
        x_np[2:] = 1000 + rng.integers(0, 4, (2, N))      # compressible
        x = jnp.asarray(x_np.view(np.int16), np.int32)
        z = jnp.zeros((B,), jnp.int32)
        zu = jnp.zeros((B,), jnp.uint32)
        n_words = clamped_frame_words(cfg, N, cap)
        assert n_words < worst_case_words(cfg, N)
        words, sizes, fell, ok = encode_blocks_device(
            cfg, None, x, x, z, zu, zu, zu, n_words, cap_bits=cap)
        ok, sizes = np.asarray(ok), np.asarray(sizes)
        # noise rows exceed the clamped frame buffer -> flagged, not silent
        assert not ok[:2].any()
        assert (sizes[:2] > n_words * 4).all()
        assert ok[2:].all()
        # ok rows are byte-exact vs the host codec
        from airs_compression_tpu.engine.context import (
            CmpContext,
            set_timestamp_func,
        )

        set_timestamp_func(lambda: (0, 0))
        try:
            for i in (2, 3):
                ref = CmpContext(params).compress_u16(x_np[i])
                dev = np.asarray(words)[i].astype(">u4").tobytes()
                assert dev[: len(ref)] == ref
        finally:
            set_timestamp_func(None)

    def test_truncated_fallback_frame_is_flagged(self):
        import dataclasses

        from airs_compression_tpu.ops.encode import (
            clamped_frame_words,
            encode_blocks_device,
            make_pass_config,
        )

        params, cfg = self._cfg()
        fb_params = dataclasses.replace(
            params, primary_preprocessing=Preprocessing.NONE,
            primary_encoder_type=EncoderType.UNCOMPRESSED)
        fb_cfg = make_pass_config(fb_params, False, True)
        B, N, cap = 4, 256, 8
        rng = np.random.default_rng(1)
        x_np = rng.integers(0, 1 << 16, (B, N)).astype(np.uint16)
        x = jnp.asarray(x_np.view(np.int16), np.int32)
        z = jnp.zeros((B,), jnp.int32)
        zu = jnp.zeros((B,), jnp.uint32)
        n_words = clamped_frame_words(cfg, N, cap)
        assert (16 + 2 * N) > n_words * 4  # fallback frame cannot fit
        words, sizes, fell, ok = encode_blocks_device(
            cfg, fb_cfg, x, x, z, zu, zu, zu, n_words, cap_bits=cap)
        fell, ok = np.asarray(fell), np.asarray(ok)
        assert fell.all()           # noise triggers the fallback
        assert not ok.any()         # ... but the fb frame was truncated


class TestDeviceDtypes:
    """i16 and i16-in-i32 through the DEVICE pipeline, oracle-checked
    (reference sample_reader.h:9-78; was host-tier-only before round 3)."""

    PARAMS = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4,
                       secondary_iterations=3,
                       secondary_preprocessing=Preprocessing.MODEL,
                       secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                       secondary_encoder_param=4,
                       model_rate=8, checksum_enabled=True)

    def _frames(self, rng, B, n):
        # values spanning the signed range so signedness is observable
        return rng.integers(-32768, 32768, (B, n)).astype(np.int16)

    @pytest.mark.parametrize("cmp_type", [CmpType.I16, CmpType.I16_IN_I32])
    def test_device_matches_host_context(self, cmp_type):
        from airs_compression_tpu.engine.context import set_timestamp_func

        B, n = 3, 128
        rng = np.random.default_rng(int(cmp_type))
        base = rng.integers(-2000, 2000, (B, n)).astype(np.int16)
        bc = BatchCompressor(self.PARAMS, B, n, cmp_type=cmp_type)
        set_timestamp_func(lambda: (0, 0))
        try:
            ctxs = [CmpContext(self.PARAMS) for _ in range(B)]
            for step in range(3):
                fr16 = (base.astype(np.int32)
                        + rng.integers(-3, 4, (B, n))).astype(np.int16)
                if cmp_type is CmpType.I16_IN_I32:
                    # wide words with garbage in the upper halves
                    garbage = rng.integers(0, 1 << 16, (B, n)).astype(np.int64)
                    frames = ((garbage << 16)
                              | (fr16.astype(np.int64) & 0xFFFF)).astype(
                                  np.int32)
                    ref = [ctxs[b].compress_i16_in_i32(frames[b])
                           for b in range(B)]
                else:
                    frames = fr16
                    ref = [ctxs[b].compress_i16(frames[b]) for b in range(B)]
                got = bc.compress_frames(frames)
                for b in range(B):
                    assert _mask_id(got[b]) == _mask_id(ref[b]), \
                        f"{cmp_type.name} step {step} block {b}"
        finally:
            set_timestamp_func(None)

    def test_i16_in_i32_device_roundtrip(self):
        from airs_compression_tpu.models.stream import BatchDecompressor

        B, n = 4, 256
        rng = np.random.default_rng(3)
        fr16 = rng.integers(-300, 300, (B, n)).astype(np.int16)
        frames = (fr16.astype(np.int64) & 0xFFFF).astype(np.int32) \
            | (1 << 20)  # garbage upper bits
        bc = BatchCompressor(self.PARAMS, B, n, cmp_type=CmpType.I16_IN_I32)
        outs = bc.compress_frames(frames)
        bd = BatchDecompressor(self.PARAMS, B, n,
                               cmp_type=CmpType.I16_IN_I32)
        dec = bd.decompress_frames(outs)
        np.testing.assert_array_equal(dec.view(np.int16), fr16)


def test_compress_frames_packed_matches_list():
    """compress_frames_packed (native row-gather stream extraction) emits
    exactly the concatenation of compress_frames' per-frame bytes, with
    identical chain-state evolution — including the fallback identifier
    patch applied inside the packed stream."""
    import dataclasses

    from airs_compression_tpu.engine.context import set_timestamp_func
    from airs_compression_tpu.models.stream import BatchCompressor

    params = dataclasses.replace(
        CmpParams(primary_preprocessing=Preprocessing.DIFF,
                  primary_encoder_type=EncoderType.GOLOMB_ZERO,
                  primary_encoder_param=1, checksum_enabled=True),
        uncompressed_fallback_enabled=True)
    B, N, K = 5, 192, 3
    rng = np.random.default_rng(60)
    set_timestamp_func(lambda: (0, 0))
    try:
        bc_l = BatchCompressor(params, B, N)
        bc_p = BatchCompressor(params, B, N)
        for k in range(K):
            frames = ((1100 + rng.normal(0, 4, (B, N))).astype(np.int64)
                      & 0xFFFF).astype(np.uint16)
            if k == 1:  # force fallbacks mid-chain
                frames[::2] = rng.integers(0, 1 << 16, frames[::2].shape,
                                           dtype=np.uint16)
            outs = bc_l.compress_frames(frames)
            stream, sizes = bc_p.compress_frames_packed(frames)
            assert stream == b"".join(outs), f"round {k}"
            assert list(sizes) == [len(o) for o in outs]
            np.testing.assert_array_equal(bc_l.seq, bc_p.seq)
            np.testing.assert_array_equal(bc_l.identifiers,
                                          bc_p.identifiers)
    finally:
        set_timestamp_func(None)


def test_bulk_identifier_draws_match_sequential():
    """_new_identifiers(k) equals k _new_identifier() calls for both the
    internal counter and a custom timestamp source."""
    from airs_compression_tpu.engine import context as ctx

    # custom source: must be invoked exactly k times, in order
    calls = []

    def stamp():
        calls.append(len(calls))
        return (len(calls), len(calls) * 3)

    ctx.set_timestamp_func(stamp)
    try:
        bulk = ctx._new_identifiers(4)
    finally:
        ctx.set_timestamp_func(None)
    assert len(calls) == 4
    expect = [((c + 1) << 16 | ((c + 1) * 3 & 0xFFFF)) & ((1 << 48) - 1)
              for c in range(4)]
    assert list(bulk) == expect
    # internal monotonic counter: bulk draw == sequential draws
    a = ctx._new_identifiers(3)
    b = [ctx._new_identifier() for _ in range(3)]
    assert list(a) == [a[0] + i for i in range(3)]
    assert b[0] == a[-1] + 1


def test_compress_frames_packed_assemble_variants():
    """Host-gather (default) and device-merge stream assembly produce
    identical bytes; as_array returns the same stream without a copy."""
    from airs_compression_tpu.engine.context import set_timestamp_func
    from airs_compression_tpu.models.stream import BatchCompressor

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=3, checksum_enabled=True)
    B, N = 6, 160  # non-power-of-two B exercises the merge padding
    rng = np.random.default_rng(70)
    frames = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    set_timestamp_func(lambda: (0, 0))
    try:
        ref, sizes = BatchCompressor(params, B, N) \
            .compress_frames_packed(frames)
        dev, _ = BatchCompressor(params, B, N) \
            .compress_frames_packed(frames, assemble="device")
        arr, _ = BatchCompressor(params, B, N) \
            .compress_frames_packed(frames, as_array=True)
    finally:
        set_timestamp_func(None)
    assert dev == ref
    assert isinstance(arr, np.ndarray) and bytes(arr) == ref

    # wildly varied per-row sizes (different noise levels + fallback
    # rows) stress every word-boundary case of the scatter assembly
    params2 = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                        primary_encoder_type=EncoderType.GOLOMB_ZERO,
                        primary_encoder_param=1,
                        uncompressed_fallback_enabled=True,
                        checksum_enabled=True)
    mixed = np.stack([
        ((1100 + rng.normal(0, s, N)).astype(np.int64) & 0xFFFF)
        for s in (0.1, 900, 4, 9000, 1, 40)]).astype(np.uint16)
    set_timestamp_func(lambda: (0, 0))
    try:
        ref2, sizes2 = BatchCompressor(params2, B, N) \
            .compress_frames_packed(mixed)
        dev2, dsz2 = BatchCompressor(params2, B, N) \
            .compress_frames_packed(mixed, assemble="device")
    finally:
        set_timestamp_func(None)
    assert len(set(sizes2)) > 2  # genuinely varied frame sizes
    np.testing.assert_array_equal(sizes2, dsz2)
    assert dev2 == ref2

    # the explicit host gather is the same stream as the default
    set_timestamp_func(lambda: (0, 0))
    try:
        host2, _ = BatchCompressor(params2, B, N) \
            .compress_frames_packed(mixed, assemble="host")
    finally:
        set_timestamp_func(None)
    assert host2 == ref2
    with pytest.raises(ValueError):
        BatchCompressor(params, B, N).compress_frames_packed(
            frames, assemble="pallas")


def test_pallas_assembly_randomized_boundaries():
    """The device stream assembly (funnel-shift merge tree,
    models/stream._pack_stream_device) reproduces a plain byte
    concatenation for arbitrary frame contents and sizes — every byte
    alignment (offs % 4), non-power-of-two batch counts, and extreme
    size variance.  Frames are synthetic random bytes (>= 4 B each, one
    word — AIRSPACE frames are >= 16 B)."""
    import sys

    from airs_compression_tpu.models.stream import _pack_stream_device

    rng = np.random.default_rng(0xA55E)
    little = sys.byteorder == "little"
    for trial in range(12):
        B = int(rng.choice([3, 5, 8, 13, 16]))
        W = int(rng.choice([8, 32, 64]))
        sizes = rng.integers(4, W * 4, size=B, endpoint=True)
        payloads = [rng.integers(0, 256, size=s, dtype=np.uint8)
                    .tobytes() for s in sizes.tolist()]
        want = b"".join(payloads)
        rows = np.zeros((B, W * 4), np.uint8)
        for b, p in enumerate(payloads):
            rows[b, : len(p)] = np.frombuffer(p, np.uint8)
        words_be = rows.reshape(B, W, 4).astype(np.uint32)
        words_be = ((words_be[..., 0] << 24) | (words_be[..., 1] << 16)
                    | (words_be[..., 2] << 8) | words_be[..., 3])
        out = _pack_stream_device(jnp.asarray(words_be, jnp.uint32),
                                  jnp.asarray(sizes, jnp.int32), little)
        got = np.ascontiguousarray(
            np.asarray(out[: (len(want) + 3) // 4])) \
            .view(np.uint8)[: len(want)].tobytes()
        assert got == want, (
            f"trial {trial}: B={B} W={W} sizes={sizes.tolist()} first "
            f"mismatch at "
            f"{next(i for i, (a, c) in enumerate(zip(got, want)) if a != c)}")
