"""CLI integration tests (modeled on the reference's Python CLI tests,
test/cli_basic_test.py + test/cli_compression_test.py), driven through
subprocesses like a real user."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, stdin: bytes = b"", cwd=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "airs_compression_tpu.cli", *args],
        input=stdin, capture_output=True, cwd=cwd, env=env, timeout=120)


@pytest.fixture()
def workdir(tmp_path):
    return tmp_path


def _write_be16(path, values):
    arr = np.asarray(values, dtype=np.uint16).astype(">u2")
    path.write_bytes(arr.tobytes())
    return arr.astype(np.uint16)


class TestBasics:
    def test_version(self):
        r = run_cli(["-q", "-V"])
        assert r.returncode == 0
        assert r.stdout.decode().strip() == "0.6.0"

    def test_help(self):
        r = run_cli(["-h"])
        assert r.returncode == 0
        assert b"Usage:" in r.stdout
        assert b"--compress" in r.stdout

    def test_invalid_option(self):
        r = run_cli(["--bogus"])
        assert r.returncode != 0
        assert b"Usage:" in r.stderr

    def test_bad_params(self):
        r = run_cli(["-c", "-p", "nonsense"])
        assert r.returncode != 0
        assert b"Incorrect parameter option" in r.stderr

    def test_stdin_console_refused(self):
        r = run_cli(["-c", "--debug-stdin-is-consol"])
        assert r.returncode != 0
        assert b"stdin is a terminal" in r.stderr


class TestCompress:
    def test_compress_file_and_roundtrip(self, workdir):
        src = workdir / "frame.dat"
        data = _write_be16(src, [1000, 1001, 999, 1002, 1000, 998])
        r = run_cli(["-c", str(src),
                     "-p", "primary_preprocessing=diff,"
                           "primary_encoder_type=golomb_zero,"
                           "primary_encoder_param=2"])
        assert r.returncode == 0, r.stderr
        out = workdir / "frame.dat.air"
        assert out.exists()
        r2 = run_cli([str(out), "-o", str(workdir / "restored.dat")])
        assert r2.returncode == 0, r2.stderr
        restored = np.frombuffer((workdir / "restored.dat").read_bytes(),
                                 dtype=">u2").astype(np.uint16)
        np.testing.assert_array_equal(restored, data)

    def test_stdin_stdout_pipe(self, workdir):
        data = np.arange(100, dtype=np.uint16)
        payload = data.astype(">u2").tobytes()
        r = run_cli(["-c"], stdin=payload)
        assert r.returncode == 0, r.stderr
        compressed = r.stdout
        assert len(compressed) >= 16
        # header starts with version flag + version id
        assert compressed[0] & 0x80
        r2 = run_cli(["-d"], stdin=compressed)
        assert r2.returncode == 0, r2.stderr
        assert r2.stdout == payload

    def test_multi_file_concat_output(self, workdir):
        a, b = workdir / "a.dat", workdir / "b.dat"
        _write_be16(a, [1, 2, 3, 4])
        _write_be16(b, [5, 6, 7, 8])
        out = workdir / "both.air"
        r = run_cli(["-c", str(a), str(b), "-o", str(out)])
        # reference semantics: with -o NAME all outputs go to NAME; ours
        # must refuse the second write (no-overwrite) exactly like the
        # reference file_save
        assert r.returncode != 0
        assert b"already exists" in r.stderr

    def test_multi_file_stdout_concatenation(self, workdir):
        a, b = workdir / "a.dat", workdir / "b.dat"
        da = _write_be16(a, [1, 2, 3, 4])
        db = _write_be16(b, [5, 6, 7, 8])
        r = run_cli(["-c", str(a), str(b), "--stdout"])
        assert r.returncode == 0, r.stderr
        r2 = run_cli(["-d"], stdin=r.stdout)
        assert r2.returncode == 0, r2.stderr
        got = np.frombuffer(r2.stdout, dtype=">u2").astype(np.uint16)
        np.testing.assert_array_equal(got, np.concatenate([da, db]))

    def test_no_overwrite(self, workdir):
        src = workdir / "x.dat"
        _write_be16(src, [1, 2])
        (workdir / "x.dat.air").write_bytes(b"occupied")
        r = run_cli(["-c", str(src)])
        assert r.returncode != 0
        assert b"already exists" in r.stderr

    def test_refuses_directory_output(self, workdir):
        src = workdir / "y.dat"
        _write_be16(src, [1, 2])
        d = workdir / "outdir"
        d.mkdir()
        r = run_cli(["-c", str(src), "-o", str(d)])
        assert r.returncode != 0
        assert b"is a directory" in r.stderr

    def test_odd_size_input_rejected(self, workdir):
        src = workdir / "odd.bin"
        src.write_bytes(b"\x01\x02\x03")
        r = run_cli(["-c", str(src)])
        assert r.returncode != 0
        assert b"not a multiple of 2" in r.stderr

    def test_model_chain_across_files(self, workdir):
        """One context chains the model across the file list
        (reference airspacecli.c:148-191)."""
        files = []
        datas = []
        rng = np.random.default_rng(0)
        for i in range(3):
            p = workdir / f"f{i}.dat"
            d = _write_be16(p, rng.integers(1000, 1010, 64))
            files.append(str(p))
            datas.append(d)
        r = run_cli(["-c", *files, "--stdout", "-p",
                     "secondary_iterations=5,"
                     "secondary_preprocessing=model,"
                     "secondary_encoder_type=golomb_zero,"
                     "secondary_encoder_param=2,model_rate=4"])
        assert r.returncode == 0, r.stderr
        r2 = run_cli(["-d"], stdin=r.stdout)
        assert r2.returncode == 0, r2.stderr
        got = np.frombuffer(r2.stdout, dtype=">u2").astype(np.uint16)
        np.testing.assert_array_equal(got, np.concatenate(datas))


class TestParamsGrammar:
    def test_prefix_and_case_insensitive(self, workdir):
        src = workdir / "z.dat"
        _write_be16(src, [7, 8, 9, 10])
        for spec in ["primary_preprocessing=CMP_PREPROCESS_DIFF",
                     "primary_preprocessing=Diff",
                     "primary_preprocessing=cmp_diff",
                     " primary_preprocessing = DIFF , "]:
            r = run_cli(["-c", str(src), "--stdout", "-p", spec])
            assert r.returncode == 0, (spec, r.stderr)

    def test_params_roundtrip(self):
        from airs_compression_tpu.cli.params_parse import (
            params_to_string, parse_params)

        p = parse_params("primary_preprocessing=iwt,"
                         "primary_encoder_type=golomb_multi,"
                         "primary_encoder_param=9,primary_encoder_outlier=77,"
                         "checksum_enabled=true")
        s = params_to_string(p)
        p2 = parse_params(s.replace("\n", ""))
        assert p == p2
