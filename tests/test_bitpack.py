"""Bit packing and the entropy-clamped frame buffer (plain XLA path).

``bitpack.pack_codes_tree`` is the packer on every platform; it is pinned
to the reference bitstream format (lib/common/bitstream_writer.h) by the
oracle parity tests.  The entropy clamp sizes frame buffers for typical
data (ops/encode.clamped_frame_words) and flags, never truncates
silently, the blocks that do not fit.
"""

import numpy as np

import jax.numpy as jnp

from airs_compression_tpu.format.params import (
    CmpParams,
    EncoderType,
    Preprocessing,
)
from airs_compression_tpu.ops import bitpack
from airs_compression_tpu.ops.encode import (
    clamped_frame_words,
    clamped_payload_words,
    encode_blocks_device,
    make_pass_config,
    worst_case_words,
)

PARAMS = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                   primary_encoder_type=EncoderType.GOLOMB_ZERO,
                   primary_encoder_param=4)


def _encode(x_np, n_words, cap=None):
    cfg = make_pass_config(PARAMS, False, True)
    B = x_np.shape[0]
    x = jnp.asarray(x_np.view(np.int16), jnp.int32)
    z = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    out = encode_blocks_device(cfg, None, x, x, z, zu, zu, zu, n_words,
                               cap_bits=cap)
    return [np.asarray(o) for o in out]


def _smooth(rng, B, N, sigma=8.5):
    return ((1100 + rng.normal(0, sigma, (B, N))).astype(np.int64)
            & 0xFFFF).astype(np.uint16)


class TestEntropyClamp:
    """Clamped frame buffers: parity when data fits, flags when not."""

    N = 1024

    def test_clamped_parity_and_ok(self):
        cfg = make_pass_config(PARAMS, False, True)
        x_np = _smooth(np.random.default_rng(0), 8, self.N)
        full_w, full_s, _ = _encode(x_np, worst_case_words(cfg, self.N))
        nw = clamped_frame_words(cfg, self.N, 10)
        w, s, _, ok = _encode(x_np, nw, cap=10)
        assert ok.all()
        np.testing.assert_array_equal(s, full_s)
        np.testing.assert_array_equal(w, full_w[:, :nw])
        assert not full_w[:, nw:].any()

    def test_overflow_flagged_not_silent(self):
        cfg = make_pass_config(PARAMS, False, True)
        rng = np.random.default_rng(1)
        x_np = _smooth(rng, 16, self.N)
        x_np[:8] = rng.integers(0, 1 << 16, (8, self.N))  # incompressible
        full_w, full_s, _ = _encode(x_np, worst_case_words(cfg, self.N))
        nw = clamped_frame_words(cfg, self.N, 10)
        w, s, _, ok = _encode(x_np, nw, cap=10)
        assert not ok[:8].any()
        assert ok[8:].all()
        # sizes stay exact even for flagged rows
        np.testing.assert_array_equal(s, full_s)
        np.testing.assert_array_equal(w[8:], full_w[8:, :nw])

    def test_clamped_output_width_bounds_stream(self):
        cfg = make_pass_config(PARAMS, False, True)
        n, cap = self.N, 10
        fw = clamped_frame_words(cfg, n, cap)
        assert fw < worst_case_words(cfg, n)
        payload = clamped_payload_words(cfg.worst_bits_per_sample, cap, n)
        # header + payload + byte pad + checksum all fit
        assert fw * 32 >= cfg.hdr_bits + payload * 32 + 7 + 32
        assert payload * 32 >= cap * n
        assert clamped_frame_words(cfg, n, None) == worst_case_words(cfg, n)


def test_merge_streams_tree_matches_single_pack():
    """Row-split pack + merge == one-shot pack."""
    rng = np.random.default_rng(12)
    K, R, W = 2048, 128, 19
    ln = rng.integers(1, 9, (K,)).astype(np.int32)
    lo = rng.integers(0, 1 << 16, (K,)).astype(np.uint32)
    lo &= ((1 << ln) - 1).astype(np.uint32)  # clean codes
    hi = np.zeros((K,), np.uint32)
    hj, lj, lnj = map(jnp.asarray, (hi, lo, ln))

    ref_w, ref_b = map(np.asarray, bitpack.pack_codes_tree(hj, lj, lnj, W))
    rows = lambda v: v.reshape(R, K // R)
    w_rows, b_rows = bitpack.pack_codes_tree(rows(hj), rows(lj), rows(lnj),
                                             W)
    got_w, got_b = map(np.asarray,
                       bitpack.merge_streams_tree(w_rows, b_rows))
    assert int(got_b) == int(ref_b)
    nw = (int(ref_b) + 31) // 32
    np.testing.assert_array_equal(ref_w[:nw], got_w[:nw])
