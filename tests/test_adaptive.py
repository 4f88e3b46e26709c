"""Adaptive per-block Golomb parameter selection (ops/adapt.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from airs_compression_tpu import (
    CmpHeader,
    CmpParams,
    EncoderType,
    Preprocessing,
    decompress,
)
from airs_compression_tpu.models.stream import BatchCompressor
from airs_compression_tpu.ops import adapt
from airs_compression_tpu.utils.bits import (
    derive_encoder_outlier,
)


def _frames(rng, B, N, sigmas):
    out = np.empty((B, N), np.uint16)
    for b in range(B):
        f = (20000 + rng.normal(0, sigmas[b % len(sigmas)], N)).astype(np.int64)
        out[b] = (f & 0xFFFF).astype(np.uint16)
    return out


class TestSelection:
    def test_cost_model_matches_encoder(self):
        """code_lengths_for must equal the true coded length."""
        from airs_compression_tpu.engine import host

        rng = np.random.default_rng(0)
        residuals = rng.integers(-200, 201, 500).astype(np.int16)
        for g in (1, 4, 10, 64, 0xFFFF):
            outlier = derive_encoder_outlier(1, g, 0)
            _, lens = host.encode_codewords(residuals, 1, g, outlier)
            mapped = jnp.asarray(host.zigzag_map(residuals).astype(np.uint32))
            got = int(adapt.code_lengths_for(mapped, g))
            assert got == int(lens.sum()), f"g={g}"

    def test_argmin_beats_fixed(self):
        rng = np.random.default_rng(1)
        res = jnp.asarray(rng.integers(-50, 51, (4, 1024)).astype(np.int32))
        g_sel, best_bits = adapt.select_golomb_zero(res)
        mapped = adapt.golomb.zigzag(res)
        for g in adapt.DEFAULT_LADDER:
            costs = adapt.code_lengths_for(mapped, g)
            assert (np.asarray(best_bits) <= np.asarray(costs)).all()

    def test_dynamic_codewords_match_static(self):
        """Per-block dynamic codegen == static codegen at the same g."""
        from airs_compression_tpu.ops import golomb as g_ops

        rng = np.random.default_rng(2)
        res = jnp.asarray(rng.integers(-3000, 3000, (3, 256)).astype(np.int32))
        for g in (1, 5, 32, 700):
            g_arr = jnp.full((3,), g, jnp.int32)
            hi_d, lo_d, ln_d = adapt.encode_codewords_dynamic(res, g_arr)
            outlier = derive_encoder_outlier(1, g, 0)
            hi_s, lo_s, ln_s = g_ops.encode_codewords(res, 1, g, outlier)
            np.testing.assert_array_equal(np.asarray(lo_d), np.asarray(lo_s))
            np.testing.assert_array_equal(np.asarray(ln_d), np.asarray(ln_s))


class TestMultiSelection:
    def test_multi_cost_model_matches_encoder(self):
        """code_lengths_for_multi must equal the true coded length."""
        from airs_compression_tpu.engine import host

        rng = np.random.default_rng(10)
        residuals = rng.integers(-3000, 3001, 500).astype(np.int16)
        caller_outlier = 100
        for g in (1, 4, 10, 64, 0xFFFF):
            outlier = derive_encoder_outlier(2, g, caller_outlier)
            _, lens = host.encode_codewords(
                residuals, EncoderType.GOLOMB_MULTI, g, outlier)
            mapped = jnp.asarray(host.zigzag_map(residuals).astype(np.uint32))
            got = int(adapt.code_lengths_for_multi(mapped, g, caller_outlier))
            assert got == int(lens.sum()), f"g={g}"

    def test_dynamic_multi_codewords_match_static(self):
        """Per-block dynamic MULTI codegen == static codegen at the same g."""
        from airs_compression_tpu.ops import golomb as g_ops

        rng = np.random.default_rng(11)
        res = jnp.asarray(rng.integers(-30000, 30000, (3, 256)).astype(np.int32))
        for g in (1, 5, 32, 700):
            outlier = derive_encoder_outlier(2, g, 50)
            g_arr = jnp.full((3,), g, jnp.int32)
            o_arr = jnp.full((3,), outlier, jnp.int32)
            hi_d, lo_d, ln_d = adapt.encode_codewords_dynamic_multi(
                res, g_arr, o_arr)
            hi_s, lo_s, ln_s = g_ops.encode_codewords(res, 2, g, outlier)
            np.testing.assert_array_equal(np.asarray(hi_d), np.asarray(hi_s))
            np.testing.assert_array_equal(np.asarray(lo_d), np.asarray(lo_s))
            np.testing.assert_array_equal(np.asarray(ln_d), np.asarray(ln_s))

    def test_multi_argmin_beats_fixed(self):
        rng = np.random.default_rng(12)
        res = jnp.asarray(rng.integers(-50, 51, (4, 1024)).astype(np.int32))
        g_sel, o_sel, best_bits = adapt.select_golomb_multi(res, 64)
        mapped = adapt.golomb.zigzag(res)
        for g in adapt.DEFAULT_LADDER:
            costs = adapt.code_lengths_for_multi(mapped, g, 64)
            assert (np.asarray(best_bits) <= np.asarray(costs)).all()


class TestAdaptivePipeline:
    def test_adaptive_stream_decodes(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4)
        B, N = 4, 512
        rng = np.random.default_rng(3)
        bc = BatchCompressor(params, B, N, adaptive=True)
        frames = _frames(rng, B, N, sigmas=[1, 8, 60, 2000])
        outs = bc.compress_frames(frames)
        gs = []
        for b, f in enumerate(outs):
            hdr, _ = CmpHeader.deserialize(f)
            gs.append(hdr.encoder_param)
            assert hdr.encoder_outlier == derive_encoder_outlier(
                1, hdr.encoder_param, 0)
            dec, _ = decompress(f)
            np.testing.assert_array_equal(dec, frames[b])
        # different noise scales should select different parameters
        assert len(set(gs)) >= 3, gs

    def test_adaptive_not_worse_than_fixed(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4)
        B, N = 4, 512
        rng = np.random.default_rng(4)
        frames = _frames(rng, B, N, sigmas=[1, 8, 60, 2000])
        bc = BatchCompressor(params, B, N, adaptive=True)
        adaptive_total = sum(map(len, bc.compress_frames(frames)))
        for g in (1, 4, 64):
            p = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                          primary_encoder_type=EncoderType.GOLOMB_ZERO,
                          primary_encoder_param=g)
            fixed = BatchCompressor(p, B, N)
            fixed_total = sum(map(len, fixed.compress_frames(frames)))
            assert adaptive_total <= fixed_total, f"worse than fixed g={g}"

    def test_adaptive_multi_stream_decodes(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_MULTI,
                           primary_encoder_param=4,
                           primary_encoder_outlier=60)
        B, N = 4, 512
        rng = np.random.default_rng(13)
        bc = BatchCompressor(params, B, N, adaptive=True)
        frames = _frames(rng, B, N, sigmas=[1, 8, 60, 2000])
        outs = bc.compress_frames(frames)
        gs = []
        for b, f in enumerate(outs):
            hdr, _ = CmpHeader.deserialize(f)
            gs.append(hdr.encoder_param)
            assert hdr.encoder_outlier == derive_encoder_outlier(
                2, hdr.encoder_param, 60)
            dec, _ = decompress(f)
            np.testing.assert_array_equal(dec, frames[b])
        assert len(set(gs)) >= 3, gs

    def test_adaptive_multi_not_worse_than_fixed(self):
        B, N = 4, 512
        rng = np.random.default_rng(14)
        frames = _frames(rng, B, N, sigmas=[1, 8, 60, 2000])
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_MULTI,
                           primary_encoder_param=4,
                           primary_encoder_outlier=60)
        bc = BatchCompressor(params, B, N, adaptive=True)
        adaptive_total = sum(map(len, bc.compress_frames(frames)))
        for g in (1, 4, 64):
            p = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                          primary_encoder_type=EncoderType.GOLOMB_MULTI,
                          primary_encoder_param=g,
                          primary_encoder_outlier=60)
            fixed = BatchCompressor(p, B, N)
            fixed_total = sum(map(len, fixed.compress_frames(frames)))
            assert adaptive_total <= fixed_total, f"worse than fixed g={g}"

    def test_adaptive_with_fallback(self):
        """Adaptive x uncompressed-fallback composition (cmp.c:342-393)."""
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           secondary_iterations=2,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=1, model_rate=8,
                           uncompressed_fallback_enabled=True)
        B, N = 3, 256
        rng = np.random.default_rng(15)
        bc = BatchCompressor(params, B, N, adaptive=True,
                             ladder=(1, 2))  # tiny ladder: noise must fall back
        # block 0: compressible; blocks 1-2: full-range noise (incompressible
        # even at the best ladder parameter -> uncompressed fallback)
        frames = np.empty((B, N), np.uint16)
        frames[0] = 1000
        frames[1:] = rng.integers(0, 1 << 16, (B - 1, N), dtype=np.uint16)
        outs = bc.compress_frames(frames)
        hdr0, _ = CmpHeader.deserialize(outs[0])
        assert hdr0.encoder_type == int(EncoderType.GOLOMB_ZERO)
        for b in (1, 2):
            hdr, _ = CmpHeader.deserialize(outs[b])
            assert hdr.preprocessing == int(Preprocessing.NONE)
            assert hdr.encoder_type == 0  # UNCOMPRESSED
            assert hdr.sequence_number == 0
            assert len(outs[b]) == 16 + 2 * N
        # chains continue correctly after the reset: fallen-back chains are
        # reseeded and run their secondary pass next call; repeating the
        # exact frame makes every MODEL residual zero (highly compressible)
        frames2 = frames.copy()
        outs2 = bc.compress_frames(frames2)
        for b in range(B):
            hdr, _ = CmpHeader.deserialize(outs2[b])
            assert hdr.sequence_number == 1
            dec, _ = decompress(outs[b] + outs2[b])
            np.testing.assert_array_equal(dec[:N], frames[b])
            np.testing.assert_array_equal(dec[N:], frames2[b])

    def test_clamped_buffer_flags_fallback_that_does_not_fit(self):
        """A fallback frame larger than an entropy-clamped buffer is
        flagged for a full-capacity re-encode, never reported ok."""
        import dataclasses

        from airs_compression_tpu.ops.encode import (
            clamped_frame_words,
            encode_blocks_adaptive,
            make_pass_config,
        )

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           uncompressed_fallback_enabled=True)
        cfg = make_pass_config(params, False, True)
        fb_cfg = make_pass_config(dataclasses.replace(
            params, primary_preprocessing=Preprocessing.NONE,
            primary_encoder_type=0), False, True)
        B, N = 2, 256
        nw = clamped_frame_words(cfg, N, 8)
        assert nw * 4 < 16 + 2 * N  # the uncompressed frame cannot fit
        frames = np.empty((B, N), np.uint16)
        frames[0] = 1000
        frames[1] = np.random.default_rng(3).integers(0, 1 << 16, N)
        x = jnp.asarray(frames.view(np.int16), jnp.int32)
        z = jnp.zeros((B,), jnp.int32)
        zu = jnp.zeros((B,), jnp.uint32)
        _w, _s, fell, _g, ok = encode_blocks_adaptive(
            cfg, fb_cfg, x, x, z, zu, zu, zu, nw, (1, 2), cap_bits=8)
        np.testing.assert_array_equal(np.asarray(fell), [False, True])
        np.testing.assert_array_equal(np.asarray(ok), [True, False])

    @pytest.mark.parametrize("enc_type,outlier", [
        (EncoderType.GOLOMB_ZERO, 0), (EncoderType.GOLOMB_MULTI, 60)])
    def test_adaptive_not_worse_than_reference_c(self, enc_type, outlier):
        """Adaptive output <= the reference C encoder's at fixed params.

        The reference (lib/compress/cmp.c) only supports caller-fixed
        Golomb parameters; exact per-block rate argmin must never lose to
        any fixed choice on the same corpus.
        """
        from oracle.wrapper import Oracle, OracleContext

        oracle = Oracle()
        B, N = 4, 512
        rng = np.random.default_rng(16)
        frames = _frames(rng, B, N, sigmas=[2, 12, 90, 900])
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=enc_type,
                           primary_encoder_param=4,
                           primary_encoder_outlier=outlier)
        bc = BatchCompressor(params, B, N, adaptive=True)
        adaptive_total = sum(map(len, bc.compress_frames(frames)))
        for g in (1, 4, 32):
            p = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                          primary_encoder_type=enc_type,
                          primary_encoder_param=g,
                          primary_encoder_outlier=outlier)
            ref_total = 0
            for b in range(B):
                octx = OracleContext(oracle, p)
                out, err = octx.compress(
                    np.ascontiguousarray(frames[b]).tobytes(), "u16")
                assert err == 0
                ref_total += len(out)
                octx.reset()
            assert adaptive_total <= ref_total, \
                f"{enc_type}: adaptive {adaptive_total} > reference C " \
                f"{ref_total} at fixed g={g}"

    def test_adaptive_chain_with_model(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4,
                           secondary_iterations=3,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=4, model_rate=8)
        B, N = 2, 256
        rng = np.random.default_rng(5)
        bc = BatchCompressor(params, B, N, adaptive=True)
        chains = [b"" for _ in range(B)]
        origs = [[] for _ in range(B)]
        for _ in range(4):
            frames = _frames(rng, B, N, sigmas=[4, 30])
            outs = bc.compress_frames(frames)
            for b in range(B):
                chains[b] += outs[b]
                origs[b].append(frames[b])
        for b in range(B):
            dec, hdrs = decompress(chains[b])
            np.testing.assert_array_equal(dec, np.concatenate(origs[b]))
            assert [h.sequence_number for h in hdrs] == [0, 1, 2, 3]


class TestFastSelection:
    """The windowed fast path must pick an equally-optimal candidate."""

    def _corpora(self):
        rng = np.random.default_rng(99)
        blocks = [rng.normal(0, s, 1024)
                  for s in (0.3, 1, 4, 15, 60, 250, 1000, 4000)]
        blocks.append(np.zeros(1024))
        blocks.append(rng.standard_t(2, 1024) * 40)
        blocks.append(rng.integers(-32768, 32767, 1024).astype(float))
        for seed in range(6):
            r = np.random.default_rng(seed)
            blocks.append(r.normal(0, r.uniform(0.1, 5000), 1024))
            blocks.append(r.standard_t(2, 1024) * r.uniform(1, 500))
        return jnp.asarray(np.stack(
            [np.clip(b, -32768, 32767) for b in blocks]).astype(np.int32))

    def test_fast_zero_cost_equals_exact(self, monkeypatch):
        res = self._corpora()
        monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", "exact")
        _, bits_exact = adapt.select_golomb_zero(res)
        monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", "fast")
        _, bits_fast = adapt.select_golomb_zero(res)
        np.testing.assert_array_equal(np.asarray(bits_fast),
                                      np.asarray(bits_exact))

    @pytest.mark.parametrize("outlier", [30, 60, 1000])
    def test_fast_multi_cost_equals_exact(self, monkeypatch, outlier):
        res = self._corpora()
        monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", "exact")
        _, _, bits_exact = adapt.select_golomb_multi(res, outlier)
        monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", "fast")
        _, _, bits_fast = adapt.select_golomb_multi(res, outlier)
        np.testing.assert_array_equal(np.asarray(bits_fast),
                                      np.asarray(bits_exact))

    def test_dynamic_length_model_matches_static(self):
        """code_lengths_dynamic(_multi) == code_lengths_for(_multi) at
        every ladder parameter (the fast path's cost model is the exact
        one, evaluated with traced parameters)."""
        res = self._corpora()[:4]
        mapped = adapt.golomb.zigzag(res)
        for g in adapt.DEFAULT_LADDER:
            garr = jnp.full((res.shape[0],), g, jnp.int32)
            np.testing.assert_array_equal(
                np.asarray(adapt.code_lengths_dynamic(mapped, garr)),
                np.asarray(adapt.code_lengths_for(mapped, g)), err_msg=str(g))
            np.testing.assert_array_equal(
                np.asarray(adapt.code_lengths_dynamic_multi(mapped, garr,
                                                            60)),
                np.asarray(adapt.code_lengths_for_multi(mapped, g, 60)),
                err_msg=f"multi {g}")
