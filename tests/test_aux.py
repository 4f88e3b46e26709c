"""Auxiliary subsystems: checkpoint/resume, profiling, gather, example."""

import os
import subprocess
import sys

import numpy as np

import pytest

from airs_compression_tpu import CmpContext, CmpParams, EncoderType, Preprocessing, decompress
from airs_compression_tpu.engine.checkpoint import (
    load_batch_state,
    load_context,
    save_batch_state,
    save_context,
)
from airs_compression_tpu.models.stream import BatchCompressor
from airs_compression_tpu.parallel.gather import StreamManifest, assemble_stream
from airs_compression_tpu.utils.profiling import StageTimer, ThroughputMeter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHAIN_PARAMS = CmpParams(
    primary_preprocessing=Preprocessing.DIFF,
    primary_encoder_type=EncoderType.GOLOMB_ZERO,
    primary_encoder_param=2,
    secondary_iterations=6,
    secondary_preprocessing=Preprocessing.MODEL,
    secondary_encoder_type=EncoderType.GOLOMB_ZERO,
    secondary_encoder_param=2,
    model_rate=8,
)


class TestCheckpoint:
    def test_context_resume(self, tmp_path):
        rng = np.random.default_rng(0)
        frames = [(1000 + rng.integers(-5, 6, 128)).astype(np.uint16)
                  for _ in range(6)]
        # uninterrupted run
        ctx_a = CmpContext(CHAIN_PARAMS)
        full = [ctx_a.compress_u16(f) for f in frames]
        # interrupted + resumed run
        ctx_b = CmpContext(CHAIN_PARAMS)
        part1 = [ctx_b.compress_u16(f) for f in frames[:3]]
        ckpt = tmp_path / "state.npz"
        save_context(ctx_b, str(ckpt))
        ctx_c = CmpContext(CHAIN_PARAMS)
        load_context(ctx_c, str(ckpt))
        part2 = [ctx_c.compress_u16(f) for f in frames[3:]]
        # payloads must match the uninterrupted chain (identifiers differ:
        # they are timestamps drawn at primary passes)
        def mask_id(b):
            ba = bytearray(b)
            ba[8:14] = b"\0" * 6
            return bytes(ba)

        for got, want in zip(part1 + part2, full):
            assert mask_id(got) == mask_id(want)
        # and the resumed stream decodes losslessly
        dec, _ = decompress(b"".join(part1 + part2))
        np.testing.assert_array_equal(dec, np.concatenate(frames))

    def test_batch_resume(self, tmp_path):
        rng = np.random.default_rng(1)
        B, N = 3, 64
        frames = [(1000 + rng.integers(-5, 6, (B, N))).astype(np.uint16)
                  for _ in range(4)]
        bc_a = BatchCompressor(CHAIN_PARAMS, B, N)
        full = [bc_a.compress_frames(f) for f in frames]
        bc_b = BatchCompressor(CHAIN_PARAMS, B, N)
        [bc_b.compress_frames(f) for f in frames[:2]]
        ckpt = tmp_path / "batch.npz"
        save_batch_state(bc_b, str(ckpt))
        bc_c = BatchCompressor(CHAIN_PARAMS, B, N)
        load_batch_state(bc_c, str(ckpt))
        rest = [bc_c.compress_frames(f) for f in frames[2:]]

        def mask_id(b):
            ba = bytearray(b)
            ba[8:14] = b"\0" * 6
            return bytes(ba)

        for step_got, step_want in zip(rest, full[2:]):
            for got, want in zip(step_got, step_want):
                assert mask_id(got) == mask_id(want)

    def test_bad_checkpoint_rejected(self, tmp_path):
        p = tmp_path / "x.npz"
        np.savez(p, magic="nope", kind="context")
        with pytest.raises(ValueError):
            load_context(CmpContext(CmpParams()), str(p))


class TestProfiling:
    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("work", nbytes=1000):
            pass
        assert "work" in t.report()

    def test_throughput_meter(self):
        m = ThroughputMeter()
        m.record(100, 50, 0.5)
        assert m.gbps > 0
        assert m.ratio == 2.0
        assert m.as_dict()["calls"] == 1

    def test_batch_metrics(self):
        bc = BatchCompressor(CmpParams(), 2, 16)
        bc.compress_frames(np.zeros((2, 16), np.uint16))
        assert bc.metrics.calls == 1
        assert bc.metrics.bytes_in == 64


class TestGather:
    def test_assemble_stream(self):
        import jax.numpy as jnp

        words = jnp.asarray(np.arange(8, dtype=np.uint32).reshape(2, 4))
        sizes = jnp.asarray(np.array([6, 9], np.int32))
        out = assemble_stream(words, sizes)
        exp = (np.arange(4, dtype=np.uint32).astype(">u4").tobytes()[:6]
               + np.arange(4, 8, dtype=np.uint32).astype(">u4").tobytes()[:9])
        assert out == exp

    def test_manifest(self):
        m = StreamManifest([2, 1], np.array([10, 20, 30]))
        assert list(m.global_order()) == [(0, 0, 10), (0, 1, 20), (1, 0, 30)]
        assert m.total_bytes == 60


@pytest.mark.parametrize("script,needle", [
    ("simple_compression.py", b"round-trip OK"),
    ("long_stream.py", b""),
    ("device_pipeline.py", b""),
    ("distributed_compression.py", b""),
    ("streaming_pipeline.py", b"pipelined decode"),
])
def test_example_runs(script, needle):
    """Every shipped example executes green on the virtual CPU mesh
    (reference runs its example as a test, examples/meson.build:9)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "examples", script)],
                       capture_output=True, timeout=900, env=env)
    assert r.returncode == 0, (script, r.stderr.decode()[-2000:])
    assert needle in r.stdout, script
