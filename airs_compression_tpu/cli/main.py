"""airspace-parity command-line interface (reference programs/airspacecli.c).

Same flags and semantics as the reference ``airspace`` binary — plus
working decompression, which the reference stubs out with "Decompression
not implemented yet" (airspacecli.c:421-423):

    airspace-tpu -c file1 file2 -o out.air     # compress (model chains
                                               #  across files, one context)
    airspace-tpu out.air -o restored.dat       # decompress (new capability)
    cat x | airspace-tpu -c > x.air            # stdin/stdout streaming

Inputs are big-endian u16 sample files; compressed outputs get the ``.air``
suffix when -o is omitted; decompressed outputs strip it.
"""

from __future__ import annotations

import os
import sys

from ..engine.context import CmpContext
from ..engine.decode import decompress_blocks
from ..format.dtypes import CmpType
from ..format.errors import CmpError
from ..format.params import CmpParams
from . import fileio
from .fileio import STD_IN_MARK, STD_OUT_MARK, FileError
from .logutil import DEBUG, INFO, LOG, make_human_readable
from .params_parse import ParseError, parse_params

AIRSPACE_EXTENSION = ".air"

_WELCOME = "*** AIRSPACE-TPU - AIRS compression on JAX ***\n"


def _print_usage(stream) -> None:
    stream.write(
        "Usage: airspace-tpu [OPTIONS...] [FILE... | -] [-o OUTPUT]\n"
        "(De)compress AIRS science data FILE(s).\n\n"
        "With no FILE, or when FILE is -, read standard input.\n"
        "\nOptions:\n"
        "  -c, --compress    Compress input files\n"
        "  -d, --decompress  Decompress input files (default)\n"
        "  -p, --params P    Compression parameters 'key=value,...'\n"
        "  -o OUTPUT         Write output to OUTPUT\n"
        "  --stdout          Write output to standard output\n"
        "  -q, --quiet       Decrease verbosity\n"
        "  -v, --verbose     Increase verbosity\n"
        "  --[no-]color      Print color codes in output\n"
        "  -V, --version     Display version\n"
        "  -h, --help        Display this help\n"
        "\nExamples:\n"
        "# Compressing file1 and file2 to output.air\n"
        "airspace-tpu -c file1 file2 -o output.air\n"
        "# Decompressing\n"
        "airspace-tpu output.air -o file1.dat\n")


def _log_file_status(level: int, input_name: str, input_size: int,
                     output_name: str, output_size: int) -> None:
    verbose = LOG.level > DEBUG
    vi, pi, si = make_human_readable(input_size, verbose)
    vo, po, so = make_human_readable(output_size, verbose)
    ratio = (output_size / input_size * 100.0) if input_size else 0.0
    LOG.msg(level, None,
            f"{input_name}: {ratio:.2f}% ({vi:.{pi}f}{si} => {vo:.{po}f}{so}, "
            f"{output_name})\n")


def _log_summary(input_files, total_in: int, output_name: str,
                 total_out: int) -> None:
    if len(input_files) == 1:
        if LOG.level < DEBUG:
            _log_file_status(INFO, input_files[0], total_in, output_name,
                             total_out)
        return
    verbose = LOG.level > DEBUG
    vi, pi, si = make_human_readable(total_in, verbose)
    vo, po, so = make_human_readable(total_out, verbose)
    ratio = (total_out / total_in * 100.0) if total_in else 0.0
    LOG.msg(INFO, None,
            f"{len(input_files)} files compressed: {ratio:.2f}% "
            f"({vi:.{pi}f}{si} => {vo:.{po}f}{so})\n")


# One AIRSPACE block holds at most 2^24-1 packed bytes (lib/cmp_header.h:19);
# bigger files are chunked into a batch of blocks and encoded on device.
_MAX_SINGLE_BLOCK_BYTES = (1 << 24) - 1


def _use_chunked(samples, params: CmpParams) -> bool:
    if params.secondary_iterations:
        return False  # model chains across files need the one-context path
    if os.environ.get("AIRS_CLI_CHUNKED") == "1":
        return True
    return samples.nbytes > _MAX_SINGLE_BLOCK_BYTES


def _compress_files(output_name, input_files, params: CmpParams) -> int:
    try:
        ctx = CmpContext(params)  # ONE context: model chains across files
    except CmpError as e:
        LOG.error(f"Compression initialization failed: {e}")
        return 1
    needs_name = output_name is None
    total_in = total_out = 0
    last_output = output_name
    for name in input_files:
        out_name = name + AIRSPACE_EXTENSION if needs_name else output_name
        last_output = out_name
        try:
            samples = fileio.load_be16(name)
            if _use_chunked(samples, params):
                # files beyond the single-block format limit (the reference
                # CLI errors on these): chunk into independent blocks and
                # batch-encode them on the device
                from ..models.chunked import compress_chunked

                LOG.debug(f"{name}: chunked device compression "
                          f"({samples.nbytes} bytes)")
                compressed = compress_chunked(params, samples)
            else:
                compressed = ctx.compress_u16(samples)
            fileio.save_bytes(out_name, compressed)
        except (FileError, CmpError) as e:
            LOG.error(str(e))
            return 1
        _log_file_status(DEBUG, name, samples.nbytes, out_name,
                         len(compressed))
        total_in += samples.nbytes
        total_out += len(compressed)
    _log_summary(input_files, total_in, last_output, total_out)
    return 0


def _strip_air_suffix(name: str) -> str:
    if name.endswith(AIRSPACE_EXTENSION) and len(name) > len(AIRSPACE_EXTENSION):
        return name[: -len(AIRSPACE_EXTENSION)]
    return name + ".dat"


_DEVICE_DECODE_MIN_BYTES = 4 << 20  # route big streams through the device


def _use_chunked_decode(stream: bytes) -> bool:
    if os.environ.get("AIRS_CLI_CHUNKED") == "1":
        return True
    if os.environ.get("AIRS_CLI_CHUNKED") == "0":
        return False
    return len(stream) > _DEVICE_DECODE_MIN_BYTES


def _decompress_files(output_name, input_files) -> int:
    total_in = total_out = 0
    last_output = output_name
    for name in input_files:
        out_name = (_strip_air_suffix(name) if output_name is None
                    else output_name)
        if output_name is None and name == STD_IN_MARK:
            out_name = STD_OUT_MARK
        last_output = out_name
        try:
            stream = fileio.load_bytes(name)
            import numpy as np

            if _use_chunked_decode(stream):
                # batches of uniform blocks decode on device (the header-
                # driven lockstep decoder); chain-dependent blocks fall back
                # to the host path inside decompress_chunked
                from ..models.chunked import decompress_chunked

                LOG.debug(f"{name}: chunked device decompression "
                          f"({len(stream)} bytes)")
                samples = decompress_chunked(stream, CmpType.U16)
            else:
                blocks = decompress_blocks(stream, CmpType.U16)
                samples = (np.concatenate([b.samples for b in blocks])
                           if blocks else np.zeros(0, np.uint16))
            fileio.save_be16(out_name, samples)
        except (FileError, CmpError) as e:
            LOG.error(str(e))
            return 1
        _log_file_status(DEBUG, name, len(stream), out_name, samples.nbytes)
        total_in += len(stream)
        total_out += samples.nbytes
    if LOG.level < DEBUG:
        _log_file_status(INFO, input_files[-1], total_in, last_output,
                         total_out)
    return 0


def main(argv=None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:
        # downstream closed the pipe (e.g. `airspace-tpu ... | head`):
        # exit quietly like a C tool dying on SIGPIPE, no traceback
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        except OSError:
            pass
        return 1


def _main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    LOG.setup_color()
    LOG.level = INFO

    mode = "decompress"
    output_name = None
    params = CmpParams()
    files: list[str] = []
    force_stdin_console = force_stdout_console = False

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("-c", "--compress"):
            mode = "compress"
        elif arg in ("-d", "--decompress"):
            mode = "decompress"
        elif arg in ("-p", "--params"):
            i += 1
            if i >= len(argv):
                LOG.error("option requires an argument -- 'p'")
                return 1
            try:
                params = parse_params(argv[i], params)
            except (ParseError, ValueError) as e:
                LOG.error(f"Incorrect parameter option: {e}")
                return 1
        elif arg == "-o":
            i += 1
            if i >= len(argv):
                LOG.error("option requires an argument -- 'o'")
                return 1
            output_name = argv[i]
        elif arg.startswith("-o") and len(arg) > 2:
            output_name = arg[2:]
        elif arg.startswith("-p") and len(arg) > 2:
            try:
                params = parse_params(arg[2:], params)
            except (ParseError, ValueError) as e:
                LOG.error(f"Incorrect parameter option: {e}")
                return 1
        elif arg == "--stdout":
            output_name = STD_OUT_MARK
        elif arg in ("-v", "--verbose"):
            LOG.increase()
        elif arg in ("-q", "--quiet"):
            LOG.decrease()
        elif arg == "--color":
            LOG.color = True
        elif arg == "--no-color":
            LOG.color = False
        elif arg in ("-V", "--version"):
            from ..format.header import CMP_VERSION_STRING

            if LOG.level < INFO:
                sys.stdout.write(f"{CMP_VERSION_STRING}\n")
            else:
                sys.stdout.write(_WELCOME)
            return 0
        elif arg in ("-h", "--help"):
            _print_usage(sys.stdout)
            return 0
        elif arg == "--debug-stdin-is-consol":
            force_stdin_console = True
        elif arg == "--debug-stdout-is-consol":
            force_stdout_console = True
        elif arg == "-":
            files.append(STD_IN_MARK)
        elif arg.startswith("-") and arg != "-":
            LOG.error(f"invalid option -- '{arg}'")
            _print_usage(sys.stderr)
            return 1
        else:
            files.append(arg)
        i += 1

    is_reading_stdin = not files or STD_IN_MARK in files
    if not files:
        files = [STD_IN_MARK]

    if is_reading_stdin:
        if force_stdin_console or sys.stdin.isatty():
            LOG.error("stdin is a terminal, aborting")
            return 1
        LOG.debug("Using stdin as an input")
        if output_name is None:
            if force_stdout_console or sys.stdout.isatty():
                LOG.error("stdout is a terminal, aborting")
                return 1
            LOG.debug("Using stdout as output")
            output_name = STD_OUT_MARK

    # no info message by default when output goes to stdout
    if output_name == STD_OUT_MARK and LOG.level == INFO:
        LOG.decrease()

    LOG.debug_plain(_WELCOME)

    if mode == "compress":
        return _compress_files(output_name, files, params)
    return _decompress_files(output_name, files)


if __name__ == "__main__":
    sys.exit(main())
