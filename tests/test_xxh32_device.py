"""Device XXH32 parity vs the host implementation (itself spec-pinned)."""

import numpy as np
import pytest

import jax.numpy as jnp

from airs_compression_tpu.ops.xxh32_device import (
    LANES,
    triton_xxh32_supported,
    xxh32_blocks,
    xxh32_blocks_triton,
)
from airs_compression_tpu.utils.xxh32 import cmp_checksum


def _ref(x_np):
    return np.asarray([cmp_checksum(row) for row in x_np], np.uint32)


@pytest.mark.parametrize("N", [1, 2, 3, 7, 8, 9, 11, 16, 64, 333, 1024])
def test_xla_matches_host(N):
    rng = np.random.default_rng(N)
    x_np = rng.integers(0, 1 << 16, (5, N)).astype(np.uint16)
    got = np.asarray(xxh32_blocks(jnp.asarray(x_np, jnp.int32)))
    np.testing.assert_array_equal(got, _ref(x_np))


def test_xla_signed_input_matches():
    """Sign-extended i16 inputs (the encoder's residual dtype) hash the
    same as their u16 packed representation."""
    rng = np.random.default_rng(0)
    x_np = rng.integers(0, 1 << 16, (4, 40)).astype(np.uint16)
    signed = jnp.asarray(x_np.view(np.int16), jnp.int32)
    got = np.asarray(xxh32_blocks(signed))
    np.testing.assert_array_equal(got, _ref(x_np))


def test_xla_seed_zero():
    x_np = np.arange(32, dtype=np.uint16)[None]
    got = int(np.asarray(xxh32_blocks(jnp.asarray(x_np, jnp.int32),
                                      seed=0))[0])
    from airs_compression_tpu.utils.xxh32 import xxh32

    assert got == xxh32(x_np.astype(">u2").tobytes(), 0)


@pytest.mark.parametrize("B,N", [(1024, 8), (1024, 64), (100, 256),
                                 (2048, 2048), (3, 2048)])
def test_pallas_matches_host(B, N):
    """Triton-route kernel (interpret mode): whole lane groups, a ragged
    last group (100 and 3 are not multiples of LANES), one stripe, and
    an unrolled stripe loop."""
    assert 100 % LANES and 3 < LANES
    assert triton_xxh32_supported(N)
    rng = np.random.default_rng(B + N)
    x_np = rng.integers(0, 1 << 16, (B, N)).astype(np.uint16)
    got = np.asarray(xxh32_blocks_triton(jnp.asarray(x_np, jnp.int32),
                                         interpret=True))
    np.testing.assert_array_equal(got, _ref(x_np))


def test_pallas_support_predicate():
    assert not triton_xxh32_supported(4)
    assert not triton_xxh32_supported(12)
    assert triton_xxh32_supported(8192)


def test_batch_compressor_device_checksum_path(monkeypatch):
    """Routing the checksum to the XLA device scan inside the encoder
    keeps frames byte-identical to the host-checksum path."""
    from airs_compression_tpu import CmpParams, EncoderType, Preprocessing
    from airs_compression_tpu.models.stream import BatchCompressor
    from airs_compression_tpu.ops import routing

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4, checksum_enabled=True)
    rng = np.random.default_rng(7)
    frames = ((1100 + rng.normal(0, 6, (4, 128))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)

    from airs_compression_tpu.engine.context import set_timestamp_func

    set_timestamp_func(lambda: (0, 0))
    try:
        ref = BatchCompressor(params, 4, 128).compress_frames(frames)
        monkeypatch.setattr(routing, "checksum_path", lambda p, n: "xla")
        got = BatchCompressor(params, 4, 128).compress_frames(frames)
    finally:
        set_timestamp_func(None)
    assert got == ref


def test_kernel_lowers_for_cuda():
    """Pallas -> Triton IR lowering of the checksum kernel at a real
    width, on the CPU (compiling the IR needs the card)."""
    import jax
    from jax import export

    exp = export.export(
        jax.jit(xxh32_blocks_triton), platforms=("cuda",),
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        jax.ShapeDtypeStruct((512, 8192), jnp.int32))
    mlir = exp.mlir_module()
    assert mlir.count("__gpu$xla.gpu.triton") == 1
    assert 'name = "airs_xxh32"' in mlir
