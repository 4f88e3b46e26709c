"""Long-stream (sequence/context) parallelism: parallel/sp.py.

Every sharded encode must be byte-identical to the single-context host
codec on the same stream — the oracle-anchored ground truth.  Runs on the
8-virtual-device CPU mesh (conftest).
"""

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
from airs_compression_tpu.parallel.mesh import make_mesh
from airs_compression_tpu.parallel.sp import (
    LongStreamCompressor,
    compress_long_stream,
)
from airs_compression_tpu.utils.xxh32 import (
    CHECKSUM_SEED,
    XXH32State,
    cmp_checksum,
    cmp_checksum_chunked,
    xxh32,
)


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


def _stream(rng, n, sigma=9.0):
    return (1100 + rng.normal(0, sigma, n)).astype(np.int64).astype(np.uint16)


def _host_frame(params, stream, identifier, seq=0, model=None):
    """Single-device ground truth with a pinned identifier."""
    from airs_compression_tpu.engine.host import compress_pass_host
    from airs_compression_tpu.format.dtypes import CmpType, SampleView

    view = SampleView(np.ascontiguousarray(stream).tobytes(), CmpType.U16)
    res = compress_pass_host(params, seq > 0, view, model, seq, identifier,
                             1 << 25)
    assert res.error == 0, res.error
    return res.compressed


class TestChecksumChunked:
    def test_streaming_equals_oneshot(self):
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
        for cuts in ([], [1], [16], [3, 20, 999], [15, 16, 17, 500]):
            st = XXH32State(CHECKSUM_SEED)
            prev = 0
            for c in cuts + [len(data)]:
                st.update(data[prev:c])
                prev = c
            assert st.intdigest() == xxh32(data, CHECKSUM_SEED)

    def test_pure_python_state_matches(self):
        """The fallback state machine must agree with the module fast path."""
        from airs_compression_tpu.utils import xxh32 as mod

        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, 333, dtype=np.uint8).tobytes()
        st = XXH32State.__new__(XXH32State)
        st._impl = None
        st._seed = CHECKSUM_SEED
        st._acc = [(CHECKSUM_SEED + mod._P1 + mod._P2) & mod._M,
                   (CHECKSUM_SEED + mod._P2) & mod._M,
                   CHECKSUM_SEED & mod._M,
                   (CHECKSUM_SEED - mod._P1) & mod._M]
        st._buf = b""
        st._total = 0
        for i in range(0, len(data), 7):
            st.update(data[i : i + 7])
        assert st.intdigest() == mod._xxh32_py(data, CHECKSUM_SEED)

    def test_chunked_sample_checksum(self):
        rng = np.random.default_rng(2)
        samples = _stream(rng, 4096)
        assert cmp_checksum_chunked(samples.reshape(8, -1)) \
            == cmp_checksum(samples)


class TestShardedPreprocessing:
    @pytest.mark.parametrize("prep", [Preprocessing.NONE, Preprocessing.DIFF,
                                      Preprocessing.IWT])
    @pytest.mark.parametrize("checksum", [False, True])
    def test_primary_pass_byte_identity(self, prep, checksum):
        mesh = make_mesh(8, "sp")
        params = CmpParams(primary_preprocessing=prep,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4,
                           checksum_enabled=checksum)
        rng = np.random.default_rng(3)
        stream = _stream(rng, 8 * 1024)
        frame = compress_long_stream(mesh, params, stream, identifier=42)
        ref = _host_frame(params, stream, identifier=42)
        assert frame == ref
        dec, _ = decompress(frame)
        np.testing.assert_array_equal(dec, stream)

    @pytest.mark.parametrize("n", [8 * 256, 8 * 4096])
    def test_iwt_sizes(self, n):
        mesh = make_mesh(8, "sp")
        params = CmpParams(primary_preprocessing=Preprocessing.IWT,
                           primary_encoder_type=EncoderType.GOLOMB_MULTI,
                           primary_encoder_param=8,
                           primary_encoder_outlier=60)
        rng = np.random.default_rng(4)
        stream = _stream(rng, n, sigma=40)
        frame = compress_long_stream(mesh, params, stream, identifier=7)
        assert frame == _host_frame(params, stream, identifier=7)

    def test_iwt_fewer_devices(self):
        """Mesh sizes 1/2/4 must all give identical bytes."""
        params = CmpParams(primary_preprocessing=Preprocessing.IWT,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4)
        rng = np.random.default_rng(5)
        stream = _stream(rng, 4096)
        ref = _host_frame(params, stream, identifier=1)
        for d in (1, 2, 4):
            mesh = make_mesh(d, "sp")
            assert compress_long_stream(mesh, params, stream,
                                        identifier=1) == ref, f"D={d}"

    def test_iwt_non_pow2_shard_rejected(self):
        mesh = make_mesh(8, "sp")
        params = CmpParams(primary_preprocessing=Preprocessing.IWT,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4)
        with pytest.raises(CmpError):
            compress_long_stream(mesh, params, np.zeros(8 * 24, np.uint16))

    def test_length_not_divisible_rejected(self):
        mesh = make_mesh(8, "sp")
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4)
        with pytest.raises(CmpError):
            compress_long_stream(mesh, params, np.zeros(1001, np.uint16))


class TestLongStreamChains:
    def _chain_vs_host(self, params, frames, fixed_time):
        mesh = make_mesh(8, "sp")
        lsc = LongStreamCompressor(mesh, params)
        got = []
        for f in frames:
            got.append(lsc.compress(f))
        # replay on the host context with the same timestamp source
        fixed_time.counter = 0
        ctx = CmpContext(params)
        ref = [ctx.compress_u16(f) for f in frames]
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g == r, f"frame {i} differs"
        dec, hdrs = decompress(b"".join(got))
        np.testing.assert_array_equal(dec, np.concatenate(frames))
        return hdrs

    def test_model_chain(self, fixed_time):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4,
                           secondary_iterations=3,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=2, model_rate=8,
                           checksum_enabled=True)
        rng = np.random.default_rng(6)
        base = _stream(rng, 2048)
        frames = [(base + rng.integers(-3, 4, 2048)).astype(np.uint16)
                  for _ in range(6)]  # 6 frames: wraps past the chain length
        hdrs = self._chain_vs_host(params, frames, fixed_time)
        assert [h.sequence_number for h in hdrs] == [0, 1, 2, 3, 0, 1]

    def test_iwt_secondary_chain(self, fixed_time):
        """IWT primary + MODEL secondary, all sharded."""
        params = CmpParams(primary_preprocessing=Preprocessing.IWT,
                           primary_encoder_type=EncoderType.GOLOMB_MULTI,
                           primary_encoder_param=8,
                           primary_encoder_outlier=100,
                           secondary_iterations=2,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=2, model_rate=4)
        rng = np.random.default_rng(7)
        base = _stream(rng, 4096, sigma=30)
        frames = [(base + rng.integers(-2, 3, 4096)).astype(np.uint16)
                  for _ in range(4)]
        self._chain_vs_host(params, frames, fixed_time)

    def test_fallback_resets_chain(self, fixed_time):
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1,
                           secondary_iterations=2,
                           secondary_preprocessing=Preprocessing.MODEL,
                           secondary_encoder_type=EncoderType.GOLOMB_ZERO,
                           secondary_encoder_param=1, model_rate=8,
                           uncompressed_fallback_enabled=True)
        rng = np.random.default_rng(8)
        noise = rng.integers(0, 1 << 16, 1024).astype(np.uint16)
        frames = [
            _stream(rng, 1024),                           # seq 0
            noise,                                        # fallback (reseeds
            #   the model with the noise frame, cmp.c:380-392 + :304-311)
            (noise + 1).astype(np.uint16),                # seq 1: MODEL pass
            #   against the reseeded model -> tiny residuals, compresses
        ]
        hdrs = self._chain_vs_host(params, frames, fixed_time)
        assert [h.sequence_number for h in hdrs] == [0, 0, 1]
        assert hdrs[1].encoder_type == 0  # UNCOMPRESSED
        assert hdrs[1].preprocessing == int(Preprocessing.NONE)


def test_sp_clamp_overflow_reencodes_full_capacity():
    """Incompressible noise (the data an entropy clamp would overflow)
    through the sharded packer must still produce host-identical bytes:
    the long-stream encoder packs at full capacity."""
    import jax
    from jax.sharding import Mesh

    from airs_compression_tpu.engine.context import (
        CmpContext,
        set_timestamp_func,
    )
    from airs_compression_tpu.format.params import (
        CmpParams,
        EncoderType,
        Preprocessing,
    )
    from airs_compression_tpu.parallel.sp import compress_long_stream

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4)
    n = 4096 * 4
    rng = np.random.default_rng(14)
    data = rng.integers(0, 1 << 16, n).astype(np.uint16)  # incompressible
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    got = compress_long_stream(mesh, params, data, identifier=3)
    set_timestamp_func(lambda: (0, 0))
    try:
        ref = CmpContext(params).compress_u16(data)
    finally:
        set_timestamp_func(None)
    assert got[14:] == ref[14:]  # identifier differs; rest byte-identical


class TestSidecarParallelDecode:
    """Chunk-parallel decode of ONE long block via the bit-offset sidecar
    (parallel/sp.stream_chunk_index + decompress_long_stream)."""

    def _roundtrip(self, params, data, model=None, chunk=1024):
        import jax
        from jax.sharding import Mesh

        from airs_compression_tpu.parallel.sp import (
            compress_long_stream,
            decompress_long_stream,
            stream_chunk_index,
        )

        mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
        frame = compress_long_stream(mesh, params, data, model=model)
        side = stream_chunk_index(params, data, chunk_samples=chunk,
                                  model=model)
        out = decompress_long_stream(frame, side, model=model)
        np.testing.assert_array_equal(out, data)
        return frame, side

    @pytest.mark.parametrize("prep", ["diff", "iwt", "none"])
    def test_roundtrip_preprocessings(self, prep):
        from airs_compression_tpu.format.params import (
            CmpParams,
            EncoderType,
            Preprocessing,
        )

        P_ = {"diff": Preprocessing.DIFF, "iwt": Preprocessing.IWT,
              "none": Preprocessing.NONE}[prep]
        params = CmpParams(primary_preprocessing=P_,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4, checksum_enabled=True)
        rng = np.random.default_rng(20)
        n = 8192
        data = ((1100 + rng.normal(0, 6, n)).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        self._roundtrip(params, data)

    def test_roundtrip_multi_encoder(self):
        from airs_compression_tpu.format.params import (
            CmpParams,
            EncoderType,
            Preprocessing,
        )

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_MULTI,
                           primary_encoder_param=3,
                           primary_encoder_outlier=40)
        rng = np.random.default_rng(21)
        data = ((1100 + rng.standard_t(2, 8192) * 20).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        self._roundtrip(params, data)

    def test_corrupt_sidecar_or_payload_detected(self):
        from airs_compression_tpu.format.errors import CmpError
        from airs_compression_tpu.format.params import (
            CmpParams,
            EncoderType,
            Preprocessing,
        )
        from airs_compression_tpu.parallel.sp import decompress_long_stream

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4, checksum_enabled=True)
        rng = np.random.default_rng(22)
        data = ((1100 + rng.normal(0, 6, 4096)).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        frame, side = self._roundtrip(params, data)
        bad_side = side.copy()
        bad_side[1] += 3  # shifted boundary -> lanes land off-boundary
        with pytest.raises(CmpError):
            decompress_long_stream(frame, bad_side)
        bad = bytearray(frame)
        bad[40] ^= 0x10  # payload corruption
        with pytest.raises(CmpError):
            decompress_long_stream(bytes(bad), side)


class TestChunkedStreamingEncode:
    """ChunkedLongStreamEncoder == compress_long_stream, byte for byte."""

    def _mesh(self, d):
        import jax
        from jax.sharding import Mesh

        return Mesh(np.array(jax.devices()[:d]), ("sp",))

    @pytest.mark.parametrize("d", [1, 4])
    @pytest.mark.parametrize("desc,kw", [
        ("diff_zero", dict(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4)),
        ("diff_zero_csum", dict(primary_preprocessing=Preprocessing.DIFF,
                                primary_encoder_type=EncoderType.GOLOMB_ZERO,
                                primary_encoder_param=4,
                                checksum_enabled=True)),
        ("none_multi", dict(primary_preprocessing=Preprocessing.NONE,
                            primary_encoder_type=EncoderType.GOLOMB_MULTI,
                            primary_encoder_param=4,
                            primary_encoder_outlier=30)),
    ])
    def test_chunked_equals_one_shot(self, d, desc, kw):
        from airs_compression_tpu.format.params import CmpParams
        from airs_compression_tpu.parallel.sp import (
            ChunkedLongStreamEncoder,
            compress_long_stream,
        )

        params = CmpParams(**kw)
        mesh = self._mesh(d)
        n, chunk = 8192, 2048
        rng = np.random.default_rng(30)
        data = ((1100 + rng.normal(0, 6, n)).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        ref = compress_long_stream(mesh, params, data, identifier=0xABCDEF)
        enc = ChunkedLongStreamEncoder(mesh, params, n, chunk,
                                       identifier=0xABCDEF)
        for k in range(n // chunk):
            enc.feed(data[k * chunk:(k + 1) * chunk])
        assert enc.finish() == ref, desc

    def test_chunked_model_secondary(self):
        from airs_compression_tpu.format.params import CmpParams
        from airs_compression_tpu.parallel.sp import (
            ChunkedLongStreamEncoder,
            compress_long_stream,
        )

        params = CmpParams(
            primary_preprocessing=Preprocessing.DIFF,
            primary_encoder_type=EncoderType.GOLOMB_ZERO,
            primary_encoder_param=4, secondary_iterations=2,
            secondary_preprocessing=Preprocessing.MODEL,
            secondary_encoder_type=EncoderType.GOLOMB_ZERO,
            secondary_encoder_param=4, model_rate=8)
        mesh = self._mesh(4)
        n, chunk = 8192, 1024
        rng = np.random.default_rng(31)
        model = ((1100 + rng.normal(0, 6, n)).astype(np.int64)
                 & 0xFFFF).astype(np.uint16).view(np.int16)
        data = ((model.view(np.uint16).astype(np.int64)
                 + rng.integers(-3, 4, n)) & 0xFFFF).astype(np.uint16)
        ref = compress_long_stream(mesh, params, data, identifier=9,
                                   sequence_number=1, model=model,
                                   secondary=True)
        enc = ChunkedLongStreamEncoder(mesh, params, n, chunk, identifier=9,
                                       sequence_number=1, secondary=True)
        for k in range(n // chunk):
            enc.feed(data[k * chunk:(k + 1) * chunk],
                     model[k * chunk:(k + 1) * chunk])
        assert enc.finish() == ref

    def test_chunked_clamp_overflow_restores(self):
        """A full-range noise chunk in the middle of a smooth stream
        (the worst case for any entropy budget) — bytes unchanged."""
        from airs_compression_tpu.format.params import CmpParams
        from airs_compression_tpu.parallel.sp import (
            ChunkedLongStreamEncoder,
            compress_long_stream,
        )

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=1)
        mesh = self._mesh(4)
        n, chunk = 8192, 2048
        rng = np.random.default_rng(32)
        data = ((1100 + rng.normal(0, 3, n)).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        # chunk 1 is full-range noise: g=1 codes at their widest
        data[chunk:2 * chunk] = rng.integers(0, 1 << 16, chunk,
                                             dtype=np.uint16)
        ref = compress_long_stream(mesh, params, data, identifier=5)
        enc = ChunkedLongStreamEncoder(mesh, params, n, chunk, identifier=5)
        for k in range(n // chunk):
            enc.feed(data[k * chunk:(k + 1) * chunk])
        assert enc.finish() == ref

    def test_chunked_sync_free_and_device_feed(self):
        """Sync-free feeds of device-resident chunks produce the
        identical frame."""
        import jax.numpy as jnp

        from airs_compression_tpu.format.params import CmpParams
        from airs_compression_tpu.parallel.sp import (
            ChunkedLongStreamEncoder,
            compress_long_stream,
        )

        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                           primary_encoder_type=EncoderType.GOLOMB_ZERO,
                           primary_encoder_param=4, checksum_enabled=True)
        mesh = self._mesh(4)
        n, chunk = 8192, 2048
        rng = np.random.default_rng(33)
        data = ((1100 + rng.normal(0, 6, n)).astype(np.int64)
                & 0xFFFF).astype(np.uint16)
        ref = compress_long_stream(mesh, params, data, identifier=3)
        enc = ChunkedLongStreamEncoder(mesh, params, n, chunk,
                                       identifier=3)
        chunks_dev = jnp.asarray(data.reshape(-1, chunk).astype(np.int32))
        for k in range(n // chunk):
            enc.feed(chunks_dev[k])
        assert enc.finish() == ref

    def test_chunked_rejects_iwt_and_misfeeds(self):
        from airs_compression_tpu.format.errors import CmpError
        from airs_compression_tpu.format.params import CmpParams
        from airs_compression_tpu.parallel.sp import ChunkedLongStreamEncoder

        mesh = self._mesh(1)
        with pytest.raises(CmpError):
            ChunkedLongStreamEncoder(
                mesh, CmpParams(primary_preprocessing=Preprocessing.IWT,
                                primary_encoder_type=EncoderType.GOLOMB_ZERO,
                                primary_encoder_param=4), 4096, 1024)
        params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                          primary_encoder_type=EncoderType.GOLOMB_ZERO,
                          primary_encoder_param=4)
        enc = ChunkedLongStreamEncoder(mesh, params, 4096, 1024)
        with pytest.raises(CmpError):
            enc.feed(np.zeros(512, np.uint16))  # wrong chunk size
        with pytest.raises(CmpError):
            enc.finish()  # underfed
