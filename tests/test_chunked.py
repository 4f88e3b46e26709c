"""Chunked whole-file device compression (models/chunked.py) + CLI routing."""

import numpy as np
import pytest

from airs_compression_tpu import (
    CmpContext,
    CmpError,
    CmpParams,
    EncoderType,
    Preprocessing,
    decompress,
    set_timestamp_func,
)
from airs_compression_tpu.models.chunked import compress_chunked


@pytest.fixture()
def fixed_time():
    class _Stub:
        counter = 0

        def __call__(self):
            c = self.counter
            self.counter += 1
            return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF

    stub = _Stub()
    set_timestamp_func(stub)
    yield stub
    set_timestamp_func(None)


def _data(rng, n, sigma=9.0):
    return (1100 + rng.normal(0, sigma, n)).astype(np.int64).astype(np.uint16)


PARAMS = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                   primary_encoder_type=EncoderType.GOLOMB_ZERO,
                   primary_encoder_param=4, checksum_enabled=True)


class TestChunkedParity:
    @pytest.mark.parametrize("n,chunk,batch", [
        (4096, 1024, 2),      # 4 full chunks, 2 device batches
        (5000, 1024, 3),      # 4 full chunks + 904-sample host tail
        (1000, 1024, 4),      # smaller than one chunk: host tail only
        (6144, 1024, 16),     # one partial batch
    ])
    def test_bit_identical_to_host_context(self, fixed_time, n, chunk, batch):
        rng = np.random.default_rng(0)
        data = _data(rng, n)
        got = compress_chunked(PARAMS, data, chunk_samples=chunk, batch=batch)
        # reference semantics: ONE host context fed the same chunk grid
        fixed_time.counter = 0
        ctx = CmpContext(PARAMS)
        ref = b"".join(ctx.compress_u16(data[i : i + chunk])
                       for i in range(0, n, chunk))
        assert got == ref
        dec, hdrs = decompress(got)
        np.testing.assert_array_equal(dec, data)
        assert all(h.sequence_number == 0 for h in hdrs)

    def test_fallback_chunks_roundtrip(self, fixed_time):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           uncompressed_fallback_enabled=True)
        rng = np.random.default_rng(1)
        data = np.concatenate([
            _data(rng, 1024),
            rng.integers(0, 1 << 16, 2048).astype(np.uint16),  # falls back
            _data(rng, 1024),
        ])
        got = compress_chunked(params, data, chunk_samples=1024, batch=4)
        dec, hdrs = decompress(got)
        np.testing.assert_array_equal(dec, data)
        assert any(h.encoder_type == 0 for h in hdrs)  # fallback happened

    def test_secondary_iterations_rejected(self):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4,
                           secondary_iterations=2,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=4, model_rate=8)
        with pytest.raises(CmpError):
            compress_chunked(params, np.zeros(100, np.uint16))

    def test_empty_rejected(self):
        with pytest.raises(CmpError):
            compress_chunked(PARAMS, np.zeros(0, np.uint16))

    def test_adaptive_chunks(self):
        """Chunked + adaptive compose (per-block parameter in each header)."""
        import functools

        from airs_compression_tpu.models.stream import BatchCompressor

        rng = np.random.default_rng(2)
        data = np.concatenate(
            [_data(rng, 1024, sigma=s) for s in (1, 40, 900)])
        got = compress_chunked(
            PARAMS, data, chunk_samples=1024, batch=4,
            compressor_cls=functools.partial(BatchCompressor, adaptive=True))
        dec, hdrs = decompress(got)
        np.testing.assert_array_equal(dec, data)
        assert len({h.encoder_param for h in hdrs}) >= 2


class TestCliChunkedRoute:
    def test_cli_large_file_chunked(self, tmp_path, monkeypatch):
        """AIRS_CLI_CHUNKED=1 routes the CLI through the device path."""
        import subprocess
        import sys

        rng = np.random.default_rng(3)
        data = _data(rng, 4096)
        src = tmp_path / "big.dat"
        src.write_bytes(data.astype(">u2").tobytes())
        out = tmp_path / "big.air"
        restored = tmp_path / "restored.dat"
        import os

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {"AIRS_CLI_CHUNKED": "1", "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": repo}

        env["PATH"] = os.environ.get("PATH", "")
        r = subprocess.run(
            [sys.executable, "-m", "airs_compression_tpu.cli", "-c",
             str(src), "-o", str(out), "-q"], env=env, capture_output=True)
        assert r.returncode == 0, r.stderr
        r = subprocess.run(
            [sys.executable, "-m", "airs_compression_tpu.cli", str(out),
             "-o", str(restored), "-q"], env=env, capture_output=True)
        assert r.returncode == 0, r.stderr
        assert restored.read_bytes() == src.read_bytes()


class TestChunkedDecompress:
    """Device-path file decompression (models/chunked.decompress_chunked)."""

    def test_matches_host_decoder(self, fixed_time):
        rng = np.random.default_rng(4)
        data = _data(rng, 8192)
        got = compress_chunked(PARAMS, data, chunk_samples=1024, batch=4)
        from airs_compression_tpu.models.chunked import decompress_chunked

        dec = decompress_chunked(got, batch=4)
        ref, _ = decompress(got)
        np.testing.assert_array_equal(dec, ref)
        np.testing.assert_array_equal(dec, data)

    def test_fallback_and_tail_blocks(self, fixed_time):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           uncompressed_fallback_enabled=True)
        rng = np.random.default_rng(5)
        data = np.concatenate([
            _data(rng, 1024),
            rng.integers(0, 1 << 16, 2048).astype(np.uint16),  # falls back
            _data(rng, 1500),  # forces a 476-sample host tail block
        ])
        got = compress_chunked(params, data, chunk_samples=1024, batch=4)
        from airs_compression_tpu.models.chunked import decompress_chunked

        dec = decompress_chunked(got, batch=4)
        np.testing.assert_array_equal(dec, data)

    def test_adaptive_stream(self, fixed_time):
        import functools

        from airs_compression_tpu.models.chunked import decompress_chunked
        from airs_compression_tpu.models.stream import BatchCompressor

        rng = np.random.default_rng(6)
        data = np.concatenate(
            [_data(rng, 1024, sigma=s) for s in (1, 40, 900, 3)])
        got = compress_chunked(
            PARAMS, data, chunk_samples=1024, batch=4,
            compressor_cls=functools.partial(BatchCompressor, adaptive=True))
        dec = decompress_chunked(got, batch=4)
        np.testing.assert_array_equal(dec, data)

    def test_model_chain_stream_uses_host_path(self, fixed_time):
        """Streams with MODEL blocks (chain state) still decode exactly."""
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=2,
                           secondary_iterations=10,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=2, model_rate=8)
        rng = np.random.default_rng(7)
        ctx = CmpContext(params)
        base = (1100 + rng.normal(0, 4, 512)).astype(np.int64)
        frames = [((base + rng.normal(0, 2, 512)).astype(np.int64)
                   & 0xFFFF).astype(np.uint16) for _ in range(4)]
        stream = b"".join(ctx.compress_u16(f) for f in frames)
        from airs_compression_tpu.models.chunked import decompress_chunked

        dec = decompress_chunked(stream)
        np.testing.assert_array_equal(dec, np.concatenate(frames))

    def test_checksum_mismatch_detected(self, fixed_time):
        rng = np.random.default_rng(8)
        data = _data(rng, 4096)
        got = bytearray(
            compress_chunked(PARAMS, data, chunk_samples=1024, batch=4))
        got[-1] ^= 0xFF  # corrupt the last block's trailing checksum
        from airs_compression_tpu.models.chunked import decompress_chunked

        with pytest.raises(CmpError):
            decompress_chunked(bytes(got), batch=4)
        # and verification can be disabled
        dec = decompress_chunked(bytes(got), batch=4,
                                 verify_checksum=False)
        np.testing.assert_array_equal(dec, data)

    def test_truncated_stream_rejected(self, fixed_time):
        rng = np.random.default_rng(9)
        data = _data(rng, 2048)
        got = compress_chunked(PARAMS, data, chunk_samples=1024, batch=2)
        from airs_compression_tpu.models.chunked import decompress_chunked

        with pytest.raises(CmpError):
            decompress_chunked(got[:-3], batch=2)

    def test_checksum_verify_device_path(self, fixed_time, monkeypatch):
        """Batch (device-parallel) checksum verification agrees with the
        host path, including mismatch detection."""
        rng = np.random.default_rng(10)
        data = _data(rng, 4096)
        got = compress_chunked(PARAMS, data, chunk_samples=1024, batch=4)
        from airs_compression_tpu.models.chunked import decompress_chunked

        from airs_compression_tpu.ops import routing

        monkeypatch.setattr(routing, "checksum_path", lambda p, n: "xla")
        dec = decompress_chunked(got, batch=4)
        np.testing.assert_array_equal(dec, data)
        bad = bytearray(got)
        bad[-1] ^= 0xFF
        with pytest.raises(CmpError):
            decompress_chunked(bytes(bad), batch=4)


def test_chunked_decode_device_staged_matches(fixed_time):
    """The device-staged file tier (stream resident on device, rows
    gathered inside the decode dispatch) returns byte-identical output
    to the host-scatter tier on the same stream, including fallback
    blocks, host tail blocks, and corrupt-checksum rejection."""
    from airs_compression_tpu.models.chunked import (
        compress_chunked,
        decompress_chunked,
    )

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=1,
                       uncompressed_fallback_enabled=True,
                       checksum_enabled=True)
    rng = np.random.default_rng(31)
    data = np.concatenate([
        _data(rng, 1024),
        rng.integers(0, 1 << 16, 2048).astype(np.uint16),  # falls back
        _data(rng, 1500),  # host tail block
    ])
    got = compress_chunked(params, data, chunk_samples=1024, batch=4)
    dec_host = decompress_chunked(got, batch=4, device_staged=False)
    dec_dev = decompress_chunked(got, batch=4, device_staged=True)
    np.testing.assert_array_equal(dec_dev, dec_host)
    np.testing.assert_array_equal(dec_dev, data)

    bad = bytearray(got)
    bad[-1] ^= 0xFF
    with pytest.raises(CmpError):
        decompress_chunked(bytes(bad), batch=4, device_staged=True)
