"""The Triton kernels compiled for the card (``gpu`` marker).

They skip without a GPU: there the same kernels run in Pallas interpret
mode (tests/test_pallas_decode.py, tests/test_xxh32_device.py), and
their lowering to Triton IR is checked by the ``*_lowers_for_cuda``
tests.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from airs_compression_tpu.format.params import (
    CmpParams,
    EncoderType,
    Preprocessing,
)

pytestmark = pytest.mark.gpu


def test_decode_kernel_matches_xla_on_card(gpu_device):
    from airs_compression_tpu.ops.decode import decode_blocks_xla
    from airs_compression_tpu.ops.encode import (
        _encode_one_pass,
        make_pass_config,
        worst_case_words,
    )
    from airs_compression_tpu.ops.pallas_decode import decode_blocks_triton

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4)
    cfg = make_pass_config(params, False, True)
    B, N = 100, 1024
    rng = np.random.default_rng(0)
    frames = ((1100 + rng.normal(0, 9, (B, N))).astype(np.int64)
              & 0xFFFF).astype(np.uint16)
    x = jnp.asarray(frames.view(np.int16), jnp.int32)
    z = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    words, _ = _encode_one_pass(cfg, x, x, z, zu, zu, zu,
                                worst_case_words(cfg, N))
    s_k, e_k = decode_blocks_triton(cfg, words, x, N)
    s_x, e_x = decode_blocks_xla(cfg, words, x, N)
    np.testing.assert_array_equal(np.asarray(s_k), np.asarray(s_x))
    np.testing.assert_array_equal(np.asarray(e_k), np.asarray(e_x))
    np.testing.assert_array_equal(np.asarray(s_k), np.asarray(x))


def test_xxh32_kernel_matches_host_on_card(gpu_device):
    from airs_compression_tpu.ops.xxh32_device import xxh32_blocks_triton
    from airs_compression_tpu.utils.xxh32 import cmp_checksum

    rng = np.random.default_rng(1)
    x_np = rng.integers(0, 1 << 16, (77, 1024)).astype(np.uint16)
    got = np.asarray(xxh32_blocks_triton(jnp.asarray(x_np, jnp.int32)))
    want = np.asarray([cmp_checksum(r) for r in x_np], np.uint32)
    np.testing.assert_array_equal(got, want)
