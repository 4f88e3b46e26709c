"""Differential fuzz: native C++ host decoder vs pure-Python host decoder.

The host decode path has two interchangeable backends — the ctypes-wrapped
C++ core (native/airs_host.cpp) and the pure-Python bit reader
(engine/host.py).  On *valid* streams both are oracle-tested elsewhere;
this module drives both explicitly over the SAME malformed corpora and
asserts identical observable behavior: same samples on success, same
CmpError code on failure, and no crash/OOB either way.  (The reference
never had to meet this bar — it has no decoder at all,
programs/airspacecli.c:421-423.)
"""

import numpy as np
import pytest

from airs_compression_tpu import (
    CmpContext,
    CmpError,
    CmpParams,
    EncoderType,
    Preprocessing,
)
from airs_compression_tpu import native
from airs_compression_tpu.engine.host import decode_block

needs_native = pytest.mark.skipif(
    not native.native_available(),
    reason="native library unavailable; nothing to differentiate")


def _decode_both(monkeypatch, blob):
    """Run decode_block on both backends -> (outcome, payload).

    outcome is "ok" with the samples, or "err" with the error code.
    """
    results = []
    for force_python in (False, True):
        with monkeypatch.context() as m:
            if force_python:
                m.setattr(native, "native_available", lambda: False)
            try:
                samples, hdr, size = decode_block(blob)
                results.append(("ok", samples.tobytes(), size))
            except CmpError as e:
                results.append(("err", e.code, None))
    return results


CONFIGS = [
    CmpParams(primary_preprocessing=Preprocessing.DIFF,
              primary_encoder_type=EncoderType.GOLOMB_ZERO,
              primary_encoder_param=4),
    CmpParams(primary_preprocessing=Preprocessing.IWT,
              primary_encoder_type=EncoderType.GOLOMB_MULTI,
              primary_encoder_param=5, primary_encoder_outlier=80,
              checksum_enabled=True),
    CmpParams(primary_preprocessing=Preprocessing.NONE,
              primary_encoder_type=EncoderType.UNCOMPRESSED),
]


def _frames():
    rng = np.random.default_rng(0)
    out = []
    for p in CONFIGS:
        data = (1100 + rng.normal(0, 9, 96)).astype(np.int64).astype(
            np.uint16)
        out.append(bytes(CmpContext(p).compress_u16(data)))
    return out


@needs_native
@pytest.mark.parametrize("fi", range(len(CONFIGS)))
def test_valid_frames_agree(monkeypatch, fi):
    blob = _frames()[fi]
    a, b = _decode_both(monkeypatch, blob)
    assert a == b
    assert a[0] == "ok"


@needs_native
def test_truncations_agree(monkeypatch):
    for blob in _frames():
        for cut in list(range(0, 24)) + [len(blob) - 5, len(blob) - 1]:
            a, b = _decode_both(monkeypatch, blob[:cut])
            assert a == b, f"cut={cut}: native {a} vs python {b}"


@needs_native
def test_single_byte_flips_agree(monkeypatch):
    rng = np.random.default_rng(1)
    for blob in _frames():
        for _ in range(80):
            pos = int(rng.integers(0, len(blob)))
            bit = 1 << int(rng.integers(0, 8))
            mutated = bytearray(blob)
            mutated[pos] ^= bit
            a, b = _decode_both(monkeypatch, bytes(mutated))
            assert a == b, f"flip@{pos}: native {a} vs python {b}"


@needs_native
def test_garbage_payload_after_valid_header_agrees(monkeypatch):
    rng = np.random.default_rng(2)
    for blob in _frames():
        hdr = blob[:22]
        for _ in range(30):
            body = rng.integers(0, 256, len(blob) - 22).astype(np.uint8)
            a, b = _decode_both(monkeypatch, hdr + body.tobytes())
            assert a == b


@needs_native
def test_random_garbage_agrees(monkeypatch):
    rng = np.random.default_rng(3)
    for _ in range(60):
        n = int(rng.integers(1, 200))
        blob = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        a, b = _decode_both(monkeypatch, blob)
        assert a == b


class TestDeviceVsHostDifferential:
    """Batch DEVICE decoder vs host decoder over mutated frames.

    BatchDecompressor (the flagship device tier) must never silently
    diverge from the per-block host oracle: when every block host-decodes
    cleanly the device samples must match bit-for-bit; when the host
    rejects any block (truncation, corrupt header, corrupt payload,
    corrupt checksum trailer) the device tier must raise ``CmpError`` —
    this is exactly the harness class that would have caught the
    checksum-blind batch tier.
    """

    CONFIGS = [
        CmpParams(primary_preprocessing=Preprocessing.DIFF,
                  primary_encoder_type=EncoderType.GOLOMB_ZERO,
                  primary_encoder_param=4),
        CmpParams(primary_preprocessing=Preprocessing.IWT,
                  primary_encoder_type=EncoderType.GOLOMB_MULTI,
                  primary_encoder_param=5, primary_encoder_outlier=80,
                  checksum_enabled=True),
        CmpParams(primary_preprocessing=Preprocessing.NONE,
                  primary_encoder_type=EncoderType.UNCOMPRESSED,
                  checksum_enabled=True),
    ]
    N = 96
    B = 4

    def _make_batch(self, params, seed):
        rng = np.random.default_rng(seed)
        frames = ((1100 + rng.normal(0, 7, (self.B, self.N)))
                  .astype(np.int64) & 0xFFFF).astype(np.uint16)
        blobs = [bytes(CmpContext(params).compress_u16(f)) for f in frames]
        return frames, blobs

    def _host_outcome(self, blobs):
        outs = []
        for f in blobs:
            try:
                s, hdr, _ = decode_block(f)
            except CmpError:
                return ("err", None)
            if hdr.original_size != 2 * self.N:
                # the batch API pins N; a mutated original_size is a
                # contract violation there (SRC_SIZE_MISMATCH)
                return ("err", None)
            outs.append(s)
        return ("ok", np.stack(outs))

    def _device_outcome(self, params, blobs):
        from airs_compression_tpu.models.stream import BatchDecompressor

        try:
            return ("ok",
                    BatchDecompressor(params, self.B, self.N)
                    .decompress_frames(list(blobs)))
        except CmpError:
            return ("err", None)

    def _check(self, params, blobs, tag):
        host = self._host_outcome(blobs)
        dev = self._device_outcome(params, blobs)
        if host[0] == "ok" and dev[0] == "ok":
            np.testing.assert_array_equal(dev[1], host[1], err_msg=tag)
        elif host[0] == "err":
            assert dev[0] == "err", \
                f"{tag}: host rejected but device returned samples"
        else:
            raise AssertionError(
                f"{tag}: device rejected a batch the host accepts")

    @pytest.mark.parametrize("ci", range(len(CONFIGS)))
    def test_clean_batches_match(self, ci):
        params = self.CONFIGS[ci]
        frames, blobs = self._make_batch(params, 50 + ci)
        self._check(params, blobs, f"clean cfg {ci}")

    @pytest.mark.parametrize("ci", range(len(CONFIGS)))
    def test_single_byte_flips(self, ci):
        params = self.CONFIGS[ci]
        rng = np.random.default_rng(60 + ci)
        _, blobs = self._make_batch(params, 60 + ci)
        for trial in range(40):
            bi = int(rng.integers(0, self.B))
            pos = int(rng.integers(0, len(blobs[bi])))
            bit = 1 << int(rng.integers(0, 8))
            mutated = list(blobs)
            m = bytearray(mutated[bi])
            m[pos] ^= bit
            mutated[bi] = bytes(m)
            self._check(params, mutated,
                        f"cfg {ci} flip@{bi}:{pos} bit {bit}")

    @pytest.mark.parametrize("ci", range(len(CONFIGS)))
    def test_payload_garbage(self, ci):
        params = self.CONFIGS[ci]
        rng = np.random.default_rng(70 + ci)
        _, blobs = self._make_batch(params, 70 + ci)
        for trial in range(10):
            bi = int(rng.integers(0, self.B))
            mutated = list(blobs)
            hdr_sz = 22 if blobs[bi][15] & 0xF7 else 16
            body = rng.integers(0, 256, len(blobs[bi]) - hdr_sz)
            mutated[bi] = blobs[bi][:hdr_sz] + bytes(
                body.astype(np.uint8).tobytes())
            self._check(params, mutated, f"cfg {ci} garbage trial {trial}")

    @pytest.mark.parametrize("ci", range(len(CONFIGS)))
    def test_truncations(self, ci):
        params = self.CONFIGS[ci]
        rng = np.random.default_rng(80 + ci)
        _, blobs = self._make_batch(params, 80 + ci)
        for cut in (0, 1, 15, 16, 21, 22, 30):
            bi = int(rng.integers(0, self.B))
            mutated = list(blobs)
            if cut >= len(blobs[bi]):
                continue
            mutated[bi] = blobs[bi][:cut]
            self._check(params, mutated, f"cfg {ci} cut {cut}")


def test_chunked_device_decode_equals_host_on_random_streams(monkeypatch):
    """Property fuzz: decompress_chunked == host decompress on random
    multi-block streams (mixed configs, sizes, fallback, checksum)."""
    import dataclasses

    from airs_compression_tpu import decompress
    from airs_compression_tpu.models.chunked import decompress_chunked

    rng = np.random.default_rng(7)
    base = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                     primary_encoder_type=EncoderType.GOLOMB_ZERO,
                     primary_encoder_param=2,
                     uncompressed_fallback_enabled=True,
                     checksum_enabled=True)
    for trial in range(6):
        n_blocks = int(rng.integers(2, 9))
        n = int(rng.integers(4, 40)) * 16
        parts = []
        expect = []
        for b in range(n_blocks):
            g = int(rng.integers(1, 9))
            p = dataclasses.replace(base, primary_encoder_param=g)
            if rng.integers(0, 3) == 0:  # noise block -> fallback
                data = rng.integers(0, 1 << 16, n).astype(np.uint16)
            else:
                data = ((1100 + rng.normal(0, g, n)).astype(np.int64)
                        & 0xFFFF).astype(np.uint16)
            parts.append(CmpContext(p).compress_u16(data))
            expect.append(data)
        stream = b"".join(parts)
        got = decompress_chunked(stream, batch=4)
        ref, _ = decompress(stream)
        np.testing.assert_array_equal(got, ref, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(got, np.concatenate(expect))
