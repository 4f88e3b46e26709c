"""Triton-route decoder parity (Pallas interpreter mode on CPU).

The GPU decoder (ops/pallas_decode.py) must reproduce the XLA scan
decoder (ops/decode.py) bit-for-bit — samples and end bit positions — and
round-trip frames produced by the device encoder.  On the GPU it is the
path for every batch.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from airs_compression_tpu.format.params import (
    CmpParams,
    EncoderType,
    Preprocessing,
)
from airs_compression_tpu.ops.decode import decode_blocks_device
from airs_compression_tpu.ops.encode import (
    _encode_one_pass,
    make_pass_config,
    worst_case_words,
)
from airs_compression_tpu.ops.pallas_decode import LANES, decode_blocks_triton

B, N = 2 * LANES, 64  # two programs; small N keeps interpreter mode fast


CONFIGS = [
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=4),
    CmpParams(primary_preprocessing=Preprocessing.NONE,
              primary_encoder_type=EncoderType.GOLOMB_MULTI,
              primary_encoder_param=2, primary_encoder_outlier=40),
    CmpParams(primary_preprocessing=Preprocessing.IWT,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=1),
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.UNCOMPRESSED),
]


@pytest.mark.parametrize("params", CONFIGS)
def test_matches_xla_decoder_and_roundtrips(params):
    rng = np.random.default_rng(hash(params.primary_encoder_type) % 1000)
    cfg = make_pass_config(params, False, True)
    frames = ((1100 + rng.normal(0, 200, (B, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    nw = worst_case_words(cfg, N)
    z = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    words, _ = _encode_one_pass(cfg, x, x, z, zu, zu, zu, nw)

    s_ref, e_ref = decode_blocks_device(cfg, words, x, N)
    s_pal, e_pal = decode_blocks_triton(cfg, words, x, N, interpret=True)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_pal))
    np.testing.assert_array_equal(np.asarray(e_ref), np.asarray(e_pal))
    np.testing.assert_array_equal(np.asarray(s_pal), np.asarray(x))


def test_non_tile_batch_is_padded_internally():
    """Any B >= 1 is accepted; padding rows must not disturb real rows."""
    Bs = LANES + 5  # not a multiple of the program's lane group
    params = CONFIGS[0]
    rng = np.random.default_rng(5)
    cfg = make_pass_config(params, False, True)
    frames = ((1100 + rng.normal(0, 50, (Bs, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    nw = worst_case_words(cfg, N)
    z = jnp.zeros((Bs,), jnp.int32)
    zu = jnp.zeros((Bs,), jnp.uint32)
    words, _ = _encode_one_pass(cfg, x, x, z, zu, zu, zu, nw)

    s_ref, e_ref = decode_blocks_device(cfg, words, x, N)
    s_pal, e_pal = decode_blocks_triton(cfg, words, x, N, interpret=True)
    assert s_pal.shape == (Bs, N) and e_pal.shape == (Bs,)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_pal))
    np.testing.assert_array_equal(np.asarray(e_ref), np.asarray(e_pal))
    np.testing.assert_array_equal(np.asarray(s_pal), np.asarray(x))


@pytest.mark.parametrize("enc", [EncoderType.GOLOMB_ZERO,
                                 EncoderType.GOLOMB_MULTI])
def test_dynamic_per_lane_params_match_xla(enc):
    """Header-driven decode: per-lane g/outlier (adaptive streams)."""
    from airs_compression_tpu.ops.encode import (
        adaptive_worst_case_words,
        encode_blocks_adaptive,
    )

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=enc,
                       primary_encoder_param=4,
                       primary_encoder_outlier=(
                           40 if enc == EncoderType.GOLOMB_MULTI else 16))
    cfg = make_pass_config(params, False, True)
    rng = np.random.default_rng(11)
    frames = np.empty((B, N), np.uint16)
    for i in range(B):  # widening noise across the batch -> g varies
        frames[i] = (1000 + rng.normal(0, 1 + (i % 12), N)).astype(
            np.int64) & 0xFFFF
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    from airs_compression_tpu.ops.adapt import DEFAULT_LADDER

    nw = adaptive_worst_case_words(cfg, N, DEFAULT_LADDER)
    z = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    words, sizes, _fb, g_sel, _ok = encode_blocks_adaptive(
        cfg, None, x, x, z, zu, zu, zu, nw, DEFAULT_LADDER)
    # per-lane params as the headers carry them
    from airs_compression_tpu.format.header import CmpHeader

    w_np = np.asarray(words)
    hdr0 = CmpHeader.deserialize(w_np[0].astype(">u4").tobytes())[0]
    g_np = np.empty((B,), np.uint32)
    o_np = np.empty((B,), np.uint32)
    for i in range(B):
        h = CmpHeader.deserialize(w_np[i].astype(">u4").tobytes())[0]
        g_np[i], o_np[i] = h.encoder_param, h.encoder_outlier
    assert len(set(g_np.tolist())) > 1
    np.testing.assert_array_equal(g_np, np.asarray(g_sel).astype(np.uint32))
    # decode cfg: g_par upper-bounds every lane (sizes the code width)
    from airs_compression_tpu.ops.encode import PassConfig

    g_cap = 1 << (int(g_np.max()) - 1).bit_length()
    dcfg = PassConfig(int(hdr0.preprocessing), int(enc), g_cap, 0,
                      False, 0, False, True)
    g_dyn = jnp.asarray(g_np)
    o_dyn = jnp.asarray(o_np)
    s_ref, e_ref = decode_blocks_device(dcfg, words, x, N,
                                        g_dyn=g_dyn, outlier_dyn=o_dyn)
    s_pal, e_pal = decode_blocks_triton(dcfg, words, x, N, interpret=True,
                                        g_dyn=g_dyn, outlier_dyn=o_dyn)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_pal))
    np.testing.assert_array_equal(np.asarray(e_ref), np.asarray(e_pal))
    np.testing.assert_array_equal(np.asarray(s_pal), np.asarray(x))


def test_garbage_words_match_xla_exactly():
    """Malformed input: random words decode to the SAME garbage, end
    positions and poison flags as the XLA scan (shared decode math,
    clipped word indices), so callers reject identically on both."""
    from airs_compression_tpu.ops.decode import BAD_CODE_POISON_BITS

    rng = np.random.default_rng(77)
    for params in CONFIGS[:2]:
        cfg = make_pass_config(params, False, True)
        words = jnp.asarray(rng.integers(0, 1 << 32, (LANES + 3, 24),
                                         dtype=np.uint64).astype(np.uint32))
        words = words.at[::4, 6:].set(0xFFFFFFFF)  # over-long unary runs
        model = jnp.zeros((LANES + 3, N), jnp.int32)
        s_ref, e_ref = decode_blocks_device(cfg, words, model, N)
        s_k, e_k = decode_blocks_triton(cfg, words, model, N,
                                        interpret=True)
        np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_k))
        np.testing.assert_array_equal(np.asarray(e_ref), np.asarray(e_k))
        assert (np.asarray(e_k) >= BAD_CODE_POISON_BITS).any()


def _lower_for_cuda(fn, *specs):
    """MLIR of ``fn`` exported for CUDA: runs the Pallas -> Triton IR
    lowering on the CPU (compiling the IR to PTX needs the card)."""
    import jax
    from jax import export

    exp = export.export(
        jax.jit(fn), platforms=("cuda",),
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*specs)
    return exp.mlir_module()


@pytest.mark.parametrize("dynamic", [False, True])
def test_decoder_lowers_for_cuda(dynamic):
    """The kernel lowers to exactly one Triton call at a real width."""
    import jax

    S = jax.ShapeDtypeStruct
    params = CONFIGS[1] if dynamic else CONFIGS[0]
    cfg = make_pass_config(params, False, True)
    Bc, Nc = 512, 8192
    specs = [S((Bc, 4096), jnp.uint32), S((Bc, Nc), jnp.int32)]
    if dynamic:
        specs += [S((Bc,), jnp.uint32), S((Bc,), jnp.uint32)]
    mlir = _lower_for_cuda(
        lambda w, m, *par: decode_blocks_triton(cfg, w, m, Nc, *par), *specs)
    assert mlir.count("__gpu$xla.gpu.triton") == 1
    assert 'name = "airs_decode"' in mlir
