"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions are correct at a tiny size (the full sizes run only on
the card, through ``python chip_smoke.py``)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture()
def fixed_ids():
    chip_smoke.set_timestamp_func(lambda: (0, 0))
    yield
    chip_smoke.set_timestamp_func(None)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_fails_outside_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_encode_and_decode_phases_tiny(fixed_ids):
    B, N = 8, 64
    frames = chip_smoke.phase_frames(B=B, N=N, batches=2)
    chains = chip_smoke.phase_chains(B=B, N=N, every=4)
    adaptive = chip_smoke.phase_adaptive(B=B, N=N)
    chip_smoke.phase_decode(frames, chains, adaptive, B=B, N=N, B2=4,
                            N2=32)


def test_file_phase_tiny(fixed_ids, monkeypatch):
    # small files take the device (chunked) CLI path only when forced
    monkeypatch.setenv("AIRS_CLI_CHUNKED", "1")
    chip_smoke.phase_file(n_samples=3 * 8192 + 100)


def test_long_phase_tiny(fixed_ids):
    chip_smoke.phase_long(n=4096, chunk=1024)


def test_kernel_phase_tiny(fixed_ids):
    res = chip_smoke.phase_kernels(shapes=((40, 64),), runs=1,
                                   assemble_shape=(8, 64), interpret=True)
    assert set(res) == {"decode_B40_N64", "xxh32_B40_N64",
                        "assemble_B8_N64"}
    json.dumps(res)


def test_four_card_phases_tiny(fixed_ids):
    """The --four phases on 4 virtual CPU devices."""
    chip_smoke.phase_dp(n_dev=4, B=8, N=64)
    chip_smoke.phase_sp(n_dev=4, n=(1 << 12) - 4, chunk_samples=124,
                        n_chunked=2048, chunk=512)
