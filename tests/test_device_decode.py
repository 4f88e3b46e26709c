"""Device decoder parity: decode_blocks_device vs host codec round-trips."""

import numpy as np
import pytest

from airs_compression_tpu import (
    CmpContext,
    CmpParams,
    EncoderType,
    Preprocessing,
)
from airs_compression_tpu.models.stream import BatchCompressor, BatchDecompressor

CONFIGS = [
    CmpParams(),
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=1),
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=7),
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
              model_rate=10),
]


@pytest.mark.parametrize("cfg_i", range(len(CONFIGS)))
@pytest.mark.parametrize("n,kind", [(64, "smooth"), (333, "noise")])
def test_device_roundtrip(cfg_i, n, kind):
    params = CONFIGS[cfg_i]
    B = 3
    rng = np.random.default_rng(17 * cfg_i + n)
    bc = BatchCompressor(params, B, n)
    bd = BatchDecompressor(params, B, n)
    n_frames = 3 if params.secondary_iterations else 2
    for fi in range(n_frames):
        if kind == "noise":
            frames = rng.integers(0, 65536, (B, n)).astype(np.uint16)
        else:
            frames = ((1100 + rng.normal(0, 6, (B, n))).astype(np.int64)
                      & 0xFFFF).astype(np.uint16)
        outs = bc.compress_frames(frames)
        dec = bd.decompress_frames(outs)
        np.testing.assert_array_equal(
            dec, frames, err_msg=f"cfg {cfg_i} frame {fi} ({kind}, n={n})")


def test_device_decode_matches_host_decoder():
    """Device decode of a host-encoded stream."""
    params = CONFIGS[2]
    n = 256
    rng = np.random.default_rng(5)
    data = ((1000 + rng.normal(0, 10, n)).astype(np.int64) & 0xFFFF
            ).astype(np.uint16)
    frame = CmpContext(params).compress_u16(data)
    bd = BatchDecompressor(params, 1, n)
    dec = bd.decompress_frames([frame])
    np.testing.assert_array_equal(dec[0], data)


def test_mixed_seq_batch_decodes_and_advances_models():
    """A batch mixing primary and secondary frames (the state after a
    fallback reset one chain) decodes correctly and keeps per-block model
    state consistent for subsequent secondary frames."""
    params = CmpParams(
        primary_preprocessing=Preprocessing.DIFF,
        primary_encoder_type=EncoderType.GOLOMB_ZERO,
        primary_encoder_param=2,
        secondary_iterations=4,
        secondary_preprocessing=Preprocessing.MODEL,
        secondary_encoder_type=EncoderType.GOLOMB_ZERO,
        secondary_encoder_param=3, model_rate=9)
    rng = np.random.default_rng(99)
    n = 96

    def frame():
        return ((1100 + rng.normal(0, 6, n)).astype(np.int64)
                & 0xFFFF).astype(np.uint16)

    ctx_a = CmpContext(params)
    a1, a2, a3 = frame(), frame(), frame()
    fa1, fa2, fa3 = (ctx_a.compress_u16(f) for f in (a1, a2, a3))

    ctx_b = CmpContext(params)
    b1 = frame()
    fb1 = ctx_b.compress_u16(b1)
    # chain b restarts (e.g. after a fallback reset): fresh context
    ctx_b2 = CmpContext(params)
    b2, b3 = frame(), frame()
    fb2, fb3 = (ctx_b2.compress_u16(f) for f in (b2, b3))

    bd = BatchDecompressor(params, 2, n)
    np.testing.assert_array_equal(bd.decompress_frames([fa1, fb1]),
                                  np.stack([a1, b1]))
    # mixed: chain a on seq 1 (secondary), chain b back on seq 0 (primary)
    np.testing.assert_array_equal(bd.decompress_frames([fa2, fb2]),
                                  np.stack([a2, b2]))
    # both secondary again; models must have advanced per block
    np.testing.assert_array_equal(bd.decompress_frames([fa3, fb3]),
                                  np.stack([a3, b3]))


class TestHeaderDrivenDecode:
    """Decode config comes from each block's parsed HEADER, not the params.

    Covers the self-describing-header contract (reference
    lib/common/header.c:89-134): uncompressed-fallback frames in a chain,
    mixed batches, and adaptive streams (per-block encoder_param) must all
    decode exactly on the device path.
    """

    def test_fallback_frames_decode_exactly(self):
        # regression: noise frames with fallback enabled used
        # to be silently misdecoded under the primary config
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           uncompressed_fallback_enabled=True)
        B, N = 8, 256
        rng = np.random.default_rng(0)
        frames = rng.integers(0, 1 << 16, (B, N)).astype(np.uint16)
        bc = BatchCompressor(params, B, N)
        outs = bc.compress_frames(frames)
        from airs_compression_tpu import CmpHeader

        hdrs = [CmpHeader.deserialize(f)[0] for f in outs]
        assert all(h.preprocessing == 0 and h.encoder_type == 0
                   for h in hdrs)  # everything fell back
        bd = BatchDecompressor(params, B, N)
        np.testing.assert_array_equal(bd.decompress_frames(outs), frames)

    def test_mixed_fallback_batch(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           uncompressed_fallback_enabled=True,
                           checksum_enabled=True)
        B, N = 8, 256
        rng = np.random.default_rng(1)
        frames = rng.integers(0, 1 << 16, (B, N)).astype(np.uint16)
        frames[:4] = (1000 + rng.normal(0, 3, (4, N))).astype(
            np.int64).astype(np.uint16)
        bc = BatchCompressor(params, B, N)
        outs = bc.compress_frames(frames)
        from airs_compression_tpu import CmpHeader

        kinds = {CmpHeader.deserialize(f)[0].encoder_type for f in outs}
        assert kinds == {0, 1}  # genuinely mixed
        bd = BatchDecompressor(params, B, N)
        np.testing.assert_array_equal(bd.decompress_frames(outs), frames)

    def test_fallback_in_model_chain_roundtrip(self):
        """A mid-chain fallback resets one chain; later secondary passes
        must keep decoding exactly (model reseeded from the fallback
        frame, reference cmp.c:380-392)."""
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=2,
                           secondary_iterations=200,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=2,
                           model_rate=8,
                           uncompressed_fallback_enabled=True)
        B, N = 4, 128
        rng = np.random.default_rng(2)
        bc = BatchCompressor(params, B, N)
        bd = BatchDecompressor(params, B, N)
        base = (1100 + rng.normal(0, 4, (B, N))).astype(np.int64)
        for step in range(5):
            frames = ((base + rng.normal(0, 3, (B, N))).astype(np.int64)
                      & 0xFFFF).astype(np.uint16)
            if step == 2:  # blow up chain 1 -> fallback mid-chain
                frames[1] = rng.integers(0, 1 << 16, N).astype(np.uint16)
            outs = bc.compress_frames(frames)
            dec = bd.decompress_frames(outs)
            np.testing.assert_array_equal(dec, frames,
                                          err_msg=f"step {step}")

    @pytest.mark.parametrize("enc", [EncoderType.GOLOMB_ZERO,
                                     EncoderType.GOLOMB_MULTI])
    def test_adaptive_stream_decodes_on_device(self, enc):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=enc,
                           primary_encoder_param=4,
                           primary_encoder_outlier=(
                               40 if enc == EncoderType.GOLOMB_MULTI else 16))
        B, N = 8, 256
        rng = np.random.default_rng(3)
        sig = np.empty((B, N), np.uint16)
        for i in range(B):  # widening noise -> different g per block
            sig[i] = (1000 + rng.normal(0, 2 ** i, N)).astype(
                np.int64) & 0xFFFF
        bc = BatchCompressor(params, B, N, adaptive=True)
        outs = bc.compress_frames(sig)
        from airs_compression_tpu import CmpHeader

        gs = {CmpHeader.deserialize(f)[0].encoder_param for f in outs}
        assert len(gs) > 1  # parameters really vary across the batch
        bd = BatchDecompressor(params, B, N)
        np.testing.assert_array_equal(bd.decompress_frames(outs), sig)

    def test_rejects_unknown_method(self):
        from airs_compression_tpu.format.errors import CmpError

        params = CmpParams()
        bc = BatchCompressor(params, 1, 8)
        (frame,) = bc.compress_frames(np.zeros((1, 8), np.uint16))
        bad = bytearray(frame)
        bad[15] = (7 << 4) | (bad[15] & 0x0F)  # preprocessing = 7
        bd = BatchDecompressor(params, 1, 8)
        with pytest.raises(CmpError):
            bd.decompress_frames([bytes(bad)])

    def test_corrupt_payload_raises_not_garbage(self):
        """Device decode mirrors the host 'payload exceeds
        compressed_size' guard instead of silently returning junk."""
        from airs_compression_tpu.format.errors import CmpError

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1)
        B, N = 4, 256
        rng = np.random.default_rng(5)
        frames = ((1100 + rng.normal(0, 2, (B, N))).astype(np.int64)
                  & 0xFFFF).astype(np.uint16)
        bc = BatchCompressor(params, B, N)
        outs = bc.compress_frames(frames)
        # overwrite one payload with all-ones: g=1 codes become huge
        # unary runs that exhaust the bitstream
        bad = bytearray(outs[2])
        for i in range(22, len(bad)):
            bad[i] = 0xFF
        outs = list(outs)
        outs[2] = bytes(bad)
        bd = BatchDecompressor(params, B, N)
        with pytest.raises(CmpError):
            bd.decompress_frames(outs)

    def test_all_frames_truncated_raises_cmp_error(self):
        """A batch whose EVERY frame is shorter than a header must raise
        CmpError (the vectorized staging once indexed past its byte
        matrix here — found by review)."""
        from airs_compression_tpu.format.errors import CmpError

        bd = BatchDecompressor(CmpParams(), 2, 64)
        for frames in ([b"\x00" * 8] * 2, [b""] * 2, [b"\x01"] * 2):
            with pytest.raises(CmpError):
                bd.decompress_frames(list(frames))

    def test_corrupt_golomb_param_raises_cmp_error(self):
        """A zeroed encoder_param in a header must raise CmpError, not a
        raw ValueError (host-decoder guard parity; found by review)."""
        from airs_compression_tpu.format.errors import CmpError

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4)
        B, N = 2, 64
        rng = np.random.default_rng(6)
        frames = ((1100 + rng.normal(0, 2, (B, N))).astype(np.int64)
                  & 0xFFFF).astype(np.uint16)
        bc = BatchCompressor(params, B, N)
        outs = list(bc.compress_frames(frames))
        bad = bytearray(outs[1])
        bad[17:19] = b"\x00\x00"  # extension encoder_param := 0
        outs[1] = bytes(bad)
        bd = BatchDecompressor(params, B, N)
        with pytest.raises(CmpError):
            bd.decompress_frames(outs)

    def test_adaptive_model_chain_roundtrip(self):
        """Adaptive selection on BOTH passes of a MODEL chain decodes on
        device across several frames (per-block g travels per header)."""
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4,
                           secondary_iterations=10,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=4, model_rate=8)
        B, N = 4, 128
        rng = np.random.default_rng(9)
        bc = BatchCompressor(params, B, N, adaptive=True)
        bd = BatchDecompressor(params, B, N)
        base = (1100 + rng.normal(0, 3, (B, N))).astype(np.int64)
        seen_g = set()
        from airs_compression_tpu import CmpHeader

        for step in range(4):
            sigma = [0.5, 2, 8, 32][step % 4]
            frames = ((base + rng.normal(0, sigma, (B, N))).astype(np.int64)
                      & 0xFFFF).astype(np.uint16)
            outs = bc.compress_frames(frames)
            seen_g |= {CmpHeader.deserialize(f)[0].encoder_param
                       for f in outs}
            dec = bd.decompress_frames(outs)
            np.testing.assert_array_equal(dec, frames,
                                          err_msg=f"step {step}")
        assert len(seen_g) > 1


class TestChecksumEnforcement:
    """The batch tier enforces the XXH32 trailer.

    The checksum bit is part of the block contract (reference
    lib/common/header.c:137-163, flag bit lib/cmp_header.h:40-44); the
    host and chunked tiers raise on a corrupt trailer — the batch tier
    must behave identically.
    """

    PARAMS = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=2, checksum_enabled=True)

    def _frames(self, B, N, seed=11):
        rng = np.random.default_rng(seed)
        return ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
                & 0xFFFF).astype(np.uint16)

    def test_corrupt_trailer_raises(self):
        """Regression: flip the last byte of a checksummed
        frame -> host decode raises AND batch decode raises."""
        from airs_compression_tpu.engine.host import decode_block
        from airs_compression_tpu.format.errors import CmpError

        B, N = 4, 128
        frames = self._frames(B, N)
        outs = list(BatchCompressor(self.PARAMS, B, N)
                    .compress_frames(frames))
        bad = bytearray(outs[2])
        bad[-1] ^= 0xFF
        outs[2] = bytes(bad)
        with pytest.raises(CmpError):
            decode_block(outs[2])
        bd = BatchDecompressor(self.PARAMS, B, N)
        with pytest.raises(CmpError, match="checksum mismatch"):
            bd.decompress_frames(outs)

    def test_corrupt_uncompressed_payload_caught(self):
        """Uncompressed-mode payload corruption can only be caught by the
        checksum (the decode itself always 'succeeds')."""
        from airs_compression_tpu.format.errors import CmpError

        params = CmpParams(checksum_enabled=True)
        B, N = 2, 64
        frames = self._frames(B, N, seed=12)
        outs = list(BatchCompressor(params, B, N).compress_frames(frames))
        bad = bytearray(outs[1])
        bad[20] ^= 0x40  # a sample byte inside the payload
        outs[1] = bytes(bad)
        bd = BatchDecompressor(params, B, N)
        with pytest.raises(CmpError, match="checksum mismatch"):
            bd.decompress_frames(outs)

    def test_verify_opt_out_matches_chunked_tier(self):
        """verify_checksum=False skips the check (same switch as
        models/chunked.decompress_chunked); a trailer flip then decodes
        to the original samples (the trailer is outside the payload)."""
        B, N = 4, 128
        frames = self._frames(B, N, seed=13)
        outs = list(BatchCompressor(self.PARAMS, B, N)
                    .compress_frames(frames))
        bad = bytearray(outs[0])
        bad[-1] ^= 0x01
        outs[0] = bytes(bad)
        bd = BatchDecompressor(self.PARAMS, B, N, verify_checksum=False)
        np.testing.assert_array_equal(bd.decompress_frames(outs), frames)

    def test_mixed_checksum_batch(self):
        """cs=1 and cs=0 blocks in one batch: only flagged blocks are
        verified; clean ones never false-positive."""
        B, N = 6, 96
        frames = self._frames(B, N, seed=14)
        cs_outs = list(BatchCompressor(self.PARAMS, B, N)
                       .compress_frames(frames))
        import dataclasses

        nocs = dataclasses.replace(self.PARAMS, checksum_enabled=False)
        nocs_outs = list(BatchCompressor(nocs, B, N)
                         .compress_frames(frames))
        mixed = [cs_outs[i] if i % 2 else nocs_outs[i] for i in range(B)]
        bd = BatchDecompressor(self.PARAMS, B, N)
        np.testing.assert_array_equal(bd.decompress_frames(mixed), frames)

    def test_fallback_frames_checksum_verified(self):
        """Fallback (NONE+UNCOMPRESSED) frames keep their checksum bit;
        corruption there must be caught too."""
        from airs_compression_tpu.format.errors import CmpError

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           uncompressed_fallback_enabled=True,
                           checksum_enabled=True)
        B, N = 4, 128
        rng = np.random.default_rng(15)
        frames = rng.integers(0, 1 << 16, (B, N)).astype(np.uint16)
        outs = list(BatchCompressor(params, B, N).compress_frames(frames))
        from airs_compression_tpu import CmpHeader

        assert all(CmpHeader.deserialize(f)[0].encoder_type == 0
                   for f in outs)  # all fell back
        bad = bytearray(outs[3])
        bad[30] ^= 0x10
        outs[3] = bytes(bad)
        bd = BatchDecompressor(params, B, N)
        with pytest.raises(CmpError, match="checksum mismatch"):
            bd.decompress_frames(outs)


def test_staged_api_matches_wrapper():
    """stage_frames/decode_staged/finish compose to decompress_frames
    (the pipelined API the decode bench times)."""
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=2, checksum_enabled=True)
    B, N = 3, 160
    rng = np.random.default_rng(21)
    frames = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    outs = BatchCompressor(params, B, N).compress_frames(frames)
    bd = BatchDecompressor(params, B, N)
    st = bd.stage_frames(outs)
    dec = bd.decode_staged(st)
    out = bd.finish(st, dec)
    np.testing.assert_array_equal(out, frames)
    # checksums verified whichever side computed them (device kernel
    # when use_device_checksum(); host xxhash otherwise) — a corrupt
    # trailer must still raise through the staged API
    from airs_compression_tpu.format.errors import CmpError

    bad = list(outs)
    m = bytearray(bad[1])
    m[-1] ^= 0xFF
    bad[1] = bytes(m)
    st2 = bd.stage_frames(bad)
    with pytest.raises(CmpError, match="checksum mismatch"):
        bd.finish(st2, bd.decode_staged(st2))


def test_randomized_config_sweep_device_vs_host():
    """Randomized parameter sweep: device batch frames byte-match per-
    block host contexts (identifier bytes masked) and device-decode back."""
    from airs_compression_tpu.engine.context import set_timestamp_func

    rng = np.random.default_rng(0)
    preps = [Preprocessing.NONE, Preprocessing.DIFF, Preprocessing.IWT]
    encs = [EncoderType.UNCOMPRESSED, EncoderType.GOLOMB_ZERO,
            EncoderType.GOLOMB_MULTI]

    def mask_id(b):
        out = bytearray(b)
        out[8:14] = b"\x00" * 6
        return bytes(out)

    set_timestamp_func(lambda: (0, 0))
    try:
        for trial in range(10):
            prep = preps[int(rng.integers(0, len(preps)))]
            enc = encs[int(rng.integers(0, len(encs)))]
            kw = dict(primary_preprocessing=prep,
                      primary_encoder_type=enc,
                      checksum_enabled=bool(rng.integers(0, 2)),
                      uncompressed_fallback_enabled=bool(
                          rng.integers(0, 2)))
            if enc != EncoderType.UNCOMPRESSED:
                kw["primary_encoder_param"] = int(rng.integers(1, 400))
            if enc == EncoderType.GOLOMB_MULTI:
                kw["primary_encoder_outlier"] = int(rng.integers(2, 5000))
            params = CmpParams(**kw)
            B = int(rng.integers(1, 5))
            n = int(rng.integers(2, 200))
            sigma = float(rng.choice([1.0, 30.0, 20000.0]))
            frames = ((1100 + rng.normal(0, sigma, (B, n))).astype(np.int64)
                      & 0xFFFF).astype(np.uint16)
            bc = BatchCompressor(params, B, n)
            outs = bc.compress_frames(frames)
            refs = [CmpContext(params).compress_u16(frames[b])
                    for b in range(B)]
            for b in range(B):
                assert mask_id(outs[b]) == mask_id(refs[b]), \
                    f"trial {trial} block {b} params {kw}"
            dec = BatchDecompressor(params, B, n).decompress_frames(outs)
            np.testing.assert_array_equal(dec, frames,
                                          err_msg=f"trial {trial} {kw}")
    finally:
        set_timestamp_func(None)


def test_stage_frames_at_matches_list_staging():
    """stage_frames_at (contiguous-stream staging by offset/length) and
    stage_frames (bytes list) produce identical staged batches and
    decode identically — the chunked file path uses the former."""
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=3, checksum_enabled=True)
    B, N = 4, 192
    rng = np.random.default_rng(41)
    frames = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    outs = list(BatchCompressor(params, B, N).compress_frames(frames))
    stream = b"".join(outs)
    lens = np.array([len(f) for f in outs], np.int64)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    bd = BatchDecompressor(params, B, N)
    st_list = bd.stage_frames(outs)
    st_at = bd.stage_frames_at(stream, offs, lens)
    np.testing.assert_array_equal(st_at.words, st_list.words)
    np.testing.assert_array_equal(st_at.stored_csum, st_list.stored_csum)
    out = bd.finish(st_at, bd.decode_staged(st_at))
    np.testing.assert_array_equal(out, frames)
    # bounds validation
    from airs_compression_tpu.format.errors import CmpError

    with pytest.raises(CmpError):
        bd.stage_frames_at(stream, offs + 10_000, lens)


def test_native_staging_matches_numpy_staging():
    """The one-pass C stage parser (native.stage_parse) and the numpy
    check matrix produce identical staged columns AND identical errors
    (same code, same failing block, same first-failing check) for every
    validation rank."""
    from airs_compression_tpu import native
    from airs_compression_tpu.format.errors import CmpError

    if not native.native_available():
        pytest.skip("native library unavailable")
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=3, checksum_enabled=True)
    B, N = 6, 128
    rng = np.random.default_rng(77)
    frames = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    outs = list(BatchCompressor(params, B, N).compress_frames(frames))
    bd = BatchDecompressor(params, B, N)

    def numpy_stage(fs):
        lens = np.fromiter((len(f) for f in fs), np.int64, count=B)
        n_words, stride = bd._staging_geometry(lens)
        buf = np.zeros((B, stride), np.uint8)
        for b, f in enumerate(fs):
            buf[b, : lens[b]] = np.frombuffer(f, np.uint8)
        return bd._stage_from_buf(buf, lens, n_words)

    st_c, st_np = bd.stage_frames(outs), numpy_stage(outs)
    for field in ("prep", "enc", "cs", "seq", "g", "outlier", "csize",
                  "stored_csum"):
        np.testing.assert_array_equal(getattr(st_c, field),
                                      getattr(st_np, field), err_msg=field)
        assert getattr(st_c, field).dtype == getattr(st_np, field).dtype
    np.testing.assert_array_equal(st_c.words, st_np.words)

    def mutate(idx, fn):
        fs = list(outs)
        b = bytearray(fs[idx])
        fn(b)
        fs[idx] = bytes(b)
        return fs

    def err(fn):
        try:
            fn()
            return None
        except CmpError as e:
            return (e.code, str(e))

    cases = [
        ("truncated header", 1, lambda b: b.__init__(b[:8])),
        ("truncated extension", 2, lambda b: b.__init__(b[:18])),
        ("csize beyond frame", 3,
         lambda b: b.__setitem__(slice(2, 5), b"\xff\xff\xff")),
        ("wrong original size", 4, lambda b: b.__setitem__(6, 0x77)),
        ("unknown method", 5, lambda b: b.__setitem__(15, 0xF7)),
        ("bad golomb param", 0,
         lambda b: b.__setitem__(slice(17, 19), b"\x00\x00")),
        ("MODEL at seq 0", 2,
         lambda b: b.__setitem__(15, (3 << 4) | (b[15] & 0xF))),
    ]
    for name, idx, fn in cases:
        fs = mutate(idx, fn)
        e_c = err(lambda: bd.stage_frames(fs))
        e_np = err(lambda: numpy_stage(fs))
        assert e_c == e_np and e_c is not None, (name, e_c, e_np)


def test_decompress_stream_matches_sequential():
    """The pipelined generator yields exactly what per-batch
    decompress_frames returns, including MODEL-chain batches whose
    finishes are deferred past the next batch's staging."""
    params = CmpParams(
        primary_preprocessing=Preprocessing.DIFF,
        primary_encoder_type=EncoderType.GOLOMB_ZERO,
        primary_encoder_param=3,
        secondary_iterations=3,
        secondary_preprocessing=Preprocessing.MODEL,
        secondary_encoder_type=EncoderType.GOLOMB_ZERO,
        secondary_encoder_param=3, model_rate=8, checksum_enabled=True)
    B, N, K = 3, 160, 4
    rng = np.random.default_rng(52)
    bc = BatchCompressor(params, B, N)
    batches, origs = [], []
    base = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
            & 0xFFFF).astype(np.uint16)
    for k in range(K):
        f = ((base.astype(np.int64) + rng.integers(-2, 3, (B, N)))
             & 0xFFFF).astype(np.uint16)
        batches.append(bc.compress_frames(f))
        origs.append(f)
    outs = list(BatchDecompressor(params, B, N).decompress_stream(
        iter(batches), depth=2))
    assert len(outs) == K
    for k in range(K):
        np.testing.assert_array_equal(outs[k], origs[k], err_msg=f"batch {k}")
    # coalescing is refused for stateful (MODEL) chains
    from airs_compression_tpu.format.errors import CmpError

    with pytest.raises(CmpError):
        list(BatchDecompressor(params, B, N).decompress_stream(
            iter(batches), coalesce=True))


def test_decompress_stream_coalesced_pairs():
    """Coalesced pair launches (decode_staged_multi) decode identically
    to per-batch launches, checksums verified, odd tail handled."""
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=3, checksum_enabled=True)
    B, N, K = 4, 160, 5  # odd batch count: last launch is un-coalesced
    rng = np.random.default_rng(53)
    bc = BatchCompressor(params, B, N)
    batches, origs = [], []
    for _ in range(K):
        f = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
             & 0xFFFF).astype(np.uint16)
        batches.append(bc.compress_frames(f))
        origs.append(f)
    bd = BatchDecompressor(params, B, N)
    outs = list(bd.decompress_stream(iter(batches), coalesce=2))
    assert len(outs) == K
    for k in range(K):
        np.testing.assert_array_equal(outs[k], origs[k], err_msg=f"batch {k}")
    # a corrupt checksum inside a coalesced pair still raises
    from airs_compression_tpu.format.errors import CmpError

    bad = [bytearray(f) for f in batches[1]]
    bad[2][-1] ^= 0xFF
    batches[1] = [bytes(b) for b in bad]
    with pytest.raises(CmpError):
        list(BatchDecompressor(params, B, N).decompress_stream(
            iter(batches), coalesce=2))


def test_decompress_stream_grouped_launches():
    """M-way launch groups (full-tile coalescing) decode identically to
    per-batch dispatch for every group size, including a non-dividing
    tail and the automatic (True / default) group."""
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=3, checksum_enabled=True)
    B, N, K = 4, 160, 7
    rng = np.random.default_rng(54)
    bc = BatchCompressor(params, B, N)
    batches, origs = [], []
    for _ in range(K):
        f = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
             & 0xFFFF).astype(np.uint16)
        batches.append(bc.compress_frames(f))
        origs.append(f)
    for coalesce in (3, True, None, False):
        bd = BatchDecompressor(params, B, N)
        outs = list(bd.decompress_stream(iter(batches), coalesce=coalesce))
        assert len(outs) == K
        for k in range(K):
            np.testing.assert_array_equal(
                outs[k], origs[k], err_msg=f"coalesce={coalesce} batch {k}")
    # invalid group sizes are rejected
    from airs_compression_tpu.format.errors import CmpError

    with pytest.raises(CmpError):
        list(BatchDecompressor(params, B, N).decompress_stream(
            iter(batches), coalesce=0))


class TestDeviceStagedDecode:
    """stage_headers_at + decode_staged_from: the row gather/alignment
    runs on device from the uploaded compressed stream; results must be
    indistinguishable from the host-scatter staging tier."""

    @staticmethod
    def _stream_of(params, B, N, seed=60, jitter=5):
        rng = np.random.default_rng(seed)
        bc = BatchCompressor(params, B, N)
        f = ((1100 + rng.normal(0, jitter, (B, N))).astype(np.int64)
             & 0xFFFF).astype(np.uint16)
        frames = bc.compress_frames(f)
        stream = b"".join(frames)
        lens = np.fromiter((len(x) for x in frames), np.int64, count=B)
        offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
        return f, frames, stream, offs, lens

    def test_matches_host_staging_uniform(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=3, checksum_enabled=True)
        B, N = 6, 192
        f, frames, stream, offs, lens = self._stream_of(params, B, N)
        bd = BatchDecompressor(params, B, N)
        ds = bd.upload_stream(stream)
        st = bd.stage_headers_at(stream, offs, lens)
        assert st.words is None and st.uniform
        out = bd.finish(st, bd.decode_staged_from(st, ds))
        np.testing.assert_array_equal(out, f)
        # header columns identical to the host-scatter staging
        st_h = bd.stage_frames_at(stream, offs, lens)
        for col in ("prep", "enc", "cs", "seq", "g", "outlier", "csize",
                    "stored_csum"):
            np.testing.assert_array_equal(getattr(st, col),
                                          getattr(st_h, col), err_msg=col)

    def test_unaligned_offsets_and_prefix(self):
        """Frames at arbitrary (non-word) byte offsets decode exactly:
        a 1..3-byte prefix shifts every frame off word alignment."""
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=3, checksum_enabled=True)
        B, N = 4, 160
        f, frames, stream, offs, lens = self._stream_of(params, B, N,
                                                        seed=61)
        for pre in (1, 2, 3):
            shifted = b"\xAA" * pre + stream
            bd = BatchDecompressor(params, B, N)
            ds = bd.upload_stream(shifted)
            st = bd.stage_headers_at(shifted, offs + pre, lens)
            out = bd.finish(st, bd.decode_staged_from(st, ds))
            np.testing.assert_array_equal(out, f, err_msg=f"prefix {pre}")

    def test_mixed_methods_fallback(self):
        """A non-uniform batch (different encoders per frame) routes
        through the gather-then-decode_staged fallback."""
        pz = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=3)
        pm = CmpParams(primary_preprocessing=Preprocessing.IWT,
                       primary_encoder_type=EncoderType.GOLOMB_MULTI,
                       primary_encoder_param=5,
                       primary_encoder_outlier=80)
        B, N = 4, 160
        rng = np.random.default_rng(62)
        f = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
             & 0xFFFF).astype(np.uint16)
        frames = []
        for b in range(B):
            ctx = CmpContext(pz if b % 2 == 0 else pm)
            frames.append(ctx.compress_u16(f[b]))
        stream = b"".join(frames)
        lens = np.fromiter((len(x) for x in frames), np.int64, count=B)
        offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
        bd = BatchDecompressor(pz, B, N)
        ds = bd.upload_stream(stream)
        st = bd.stage_headers_at(stream, offs, lens)
        assert not st.uniform
        out = bd.finish(st, bd.decode_staged_from(st, ds))
        np.testing.assert_array_equal(out, f)

    def test_model_chain(self):
        """MODEL-preprocessed secondary frames decode via the fused
        stream path with the chain state carried across calls."""
        params = CmpParams(
            primary_preprocessing=Preprocessing.DIFF,
            primary_encoder_type=EncoderType.GOLOMB_ZERO,
            primary_encoder_param=3,
            secondary_iterations=3,
            secondary_preprocessing=Preprocessing.MODEL,
            secondary_encoder_type=EncoderType.GOLOMB_ZERO,
            secondary_encoder_param=3, model_rate=8,
            checksum_enabled=True)
        B, N, K = 3, 160, 3
        rng = np.random.default_rng(63)
        bc = BatchCompressor(params, B, N)
        base = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        batches, origs = [], []
        for _ in range(K):
            f = ((base.astype(np.int64) + rng.integers(-2, 3, (B, N)))
                 & 0xFFFF).astype(np.uint16)
            batches.append(bc.compress_frames(f))
            origs.append(f)
        bd = BatchDecompressor(params, B, N)
        for k in range(K):
            frames = batches[k]
            stream = b"".join(frames)
            lens = np.fromiter((len(x) for x in frames), np.int64,
                               count=B)
            offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
            ds = bd.upload_stream(stream)
            st = bd.stage_headers_at(stream, offs, lens)
            out = bd.finish(st, bd.decode_staged_from(st, ds))
            np.testing.assert_array_equal(out, origs[k],
                                          err_msg=f"batch {k}")

    def test_corrupt_checksum_raises(self):
        from airs_compression_tpu.format.errors import CmpError

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=3, checksum_enabled=True)
        B, N = 4, 160
        f, frames, stream, offs, lens = self._stream_of(params, B, N,
                                                        seed=64)
        bad = bytearray(stream)
        bad[int(offs[2] + lens[2]) - 1] ^= 0xFF  # block 2's trailer
        bad = bytes(bad)
        bd = BatchDecompressor(params, B, N)
        ds = bd.upload_stream(bad)
        st = bd.stage_headers_at(bad, offs, lens)
        with pytest.raises(CmpError):
            bd.finish(st, bd.decode_staged_from(st, ds))

    def test_validation_parity_with_host_staging(self):
        """Corrupt headers raise the same error from both staging tiers."""
        from airs_compression_tpu.format.errors import CmpError

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=3)
        B, N = 4, 160
        f, frames, stream, offs, lens = self._stream_of(params, B, N,
                                                        seed=65)
        bd = BatchDecompressor(params, B, N)

        def err(fn):
            try:
                fn()
            except CmpError as e:
                return (e.code, str(e))
            return None

        # truncated header frame
        s2 = bytearray(stream)
        lens2 = lens.copy()
        lens2[1] = 8
        s2 = bytes(s2)
        e_dev = err(lambda: bd.stage_headers_at(s2, offs, lens2))
        e_host = err(lambda: bd.stage_frames_at(s2, offs, lens2))
        assert e_dev == e_host and e_dev is not None
        # bad golomb parameter in header (extension bytes 17..18)
        s3 = bytearray(stream)
        s3[int(offs[1]) + 17:int(offs[1]) + 19] = b"\x00\x00"
        s3 = bytes(s3)
        e_dev = err(lambda: bd.stage_headers_at(s3, offs, lens))
        e_host = err(lambda: bd.stage_frames_at(s3, offs, lens))
        assert e_dev == e_host and e_dev is not None
        # wrong original size (bytes 5..8)
        s4 = bytearray(stream)
        s4[int(offs[2]) + 5:int(offs[2]) + 8] = b"\x00\x00\x01"
        s4 = bytes(s4)
        e_dev = err(lambda: bd.stage_headers_at(s4, offs, lens))
        e_host = err(lambda: bd.stage_frames_at(s4, offs, lens))
        assert e_dev == e_host and e_dev is not None

    def test_grouped_stream_decode_and_file_driver(self):
        """decode_staged_from_multi (one fused dispatch per group) and
        the decompress_file_stream driver equal per-batch results."""
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=3, checksum_enabled=True)
        B, N, K = 4, 160, 6
        rng = np.random.default_rng(66)
        bc = BatchCompressor(params, B, N)
        frames, origs = [], []
        for _ in range(K):
            f = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
                 & 0xFFFF).astype(np.uint16)
            frames.extend(bc.compress_frames(f))
            origs.append(f)
        stream = b"".join(frames)
        lens = np.fromiter((len(x) for x in frames), np.int64,
                           count=B * K)
        offs = np.concatenate(([0], np.cumsum(lens)[:-1]))

        bd = BatchDecompressor(params, B, N)
        ds = bd.upload_stream(stream)
        sts = [bd.stage_headers_at(stream, offs[w * B:(w + 1) * B],
                                   lens[w * B:(w + 1) * B])
               for w in range(K)]
        decs = bd.decode_staged_from_multi(sts, ds)
        for w in range(K):
            np.testing.assert_array_equal(bd.finish(sts[w], decs[w]),
                                          origs[w], err_msg=f"win {w}")

        for coalesce in (None, 1, 3):
            bd2 = BatchDecompressor(params, B, N)
            outs = list(bd2.decompress_file_stream(stream, offs, lens,
                                                   coalesce=coalesce))
            assert len(outs) == K
            for w in range(K):
                np.testing.assert_array_equal(
                    outs[w], origs[w],
                    err_msg=f"coalesce={coalesce} win {w}")

    def test_file_driver_model_chain(self):
        """decompress_file_stream carries MODEL chain state across
        windows (group forced to 1 for stateful streams)."""
        params = CmpParams(
            primary_preprocessing=Preprocessing.DIFF,
            primary_encoder_type=EncoderType.GOLOMB_ZERO,
            primary_encoder_param=3,
            secondary_iterations=4,
            secondary_preprocessing=Preprocessing.MODEL,
            secondary_encoder_type=EncoderType.GOLOMB_ZERO,
            secondary_encoder_param=3, model_rate=8,
            checksum_enabled=True)
        B, N, K = 3, 160, 4
        rng = np.random.default_rng(67)
        bc = BatchCompressor(params, B, N)
        base = ((1100 + rng.normal(0, 5, (B, N))).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        frames, origs = [], []
        for _ in range(K):
            f = ((base.astype(np.int64) + rng.integers(-2, 3, (B, N)))
                 & 0xFFFF).astype(np.uint16)
            frames.extend(bc.compress_frames(f))
            origs.append(f)
        stream = b"".join(frames)
        lens = np.fromiter((len(x) for x in frames), np.int64,
                           count=B * K)
        offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
        bd = BatchDecompressor(params, B, N)
        outs = list(bd.decompress_file_stream(stream, offs, lens))
        assert len(outs) == K
        for w in range(K):
            np.testing.assert_array_equal(outs[w], origs[w],
                                          err_msg=f"win {w}")

    def test_native_vs_numpy_header_staging(self, monkeypatch):
        """stage_headers_at's native C parse and numpy fallback return
        identical columns on valid streams and identical errors on the
        malformed corpus."""
        from airs_compression_tpu import native
        from airs_compression_tpu.format.errors import CmpError

        if not native.native_available():
            pytest.skip("no native toolchain")
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=3, checksum_enabled=True)
        B, N = 5, 160
        f, frames, stream, offs, lens = self._stream_of(params, B, N,
                                                        seed=68)
        bd = BatchDecompressor(params, B, N)

        def run(s, o, ln, use_native):
            if not use_native:
                monkeypatch.setattr(native, "native_available",
                                    lambda: False)
            try:
                st = bd.stage_headers_at(s, o, ln)
            except CmpError as e:
                return (e.code, str(e))
            finally:
                monkeypatch.undo()
            return st

        st_c = run(stream, offs, lens, True)
        st_np = run(stream, offs, lens, False)
        for field in ("prep", "enc", "cs", "seq", "g", "outlier", "csize",
                      "stored_csum", "row_off", "row_len"):
            np.testing.assert_array_equal(getattr(st_c, field),
                                          getattr(st_np, field),
                                          err_msg=field)
        assert st_c.uniform == st_np.uniform

        # malformed corpus: same (code, message) from both backends
        muts = []
        s2 = bytearray(stream)
        s2[int(offs[1]) + 15] = 0xF7  # unknown method byte
        muts.append((bytes(s2), offs, lens))
        s3 = bytearray(stream)
        s3[int(offs[2]) + 17:int(offs[2]) + 19] = b"\x00\x00"  # g=0
        muts.append((bytes(s3), offs, lens))
        lens4 = lens.copy()
        lens4[0] = 8  # truncated header
        muts.append((stream, offs, lens4))
        s5 = bytearray(stream)
        s5[int(offs[3]) + 5:int(offs[3]) + 8] = b"\x00\x00\x02"  # orig size
        muts.append((bytes(s5), offs, lens))
        for i, (s, o, ln) in enumerate(muts):
            e_c = run(s, o, ln, True)
            e_np = run(s, o, ln, False)
            assert isinstance(e_c, tuple) and e_c == e_np, (i, e_c, e_np)
