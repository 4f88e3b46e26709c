"""Multi-host execution test: 2 real processes over jax.distributed.

Spawns tests/multihost_worker.py twice with a clean CPU environment and
gloo cross-process collectives; each process owns 2 virtual CPU devices, so
the global mesh is 2 processes x 2 devices = 4.  The worker performs the
full distributed encode -> size allgather -> manifest -> splice ->
byte-parity -> decode round-trip (see its docstring).
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return env


def test_two_process_end_to_end(tmp_path):
    nproc = 2
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err}"
    ok = tmp_path / "OK"
    assert ok.exists(), "process 0 did not write the verification marker"
    assert "procs=2" in ok.read_text()
    assert "devices=4" in ok.read_text()
