"""Where each device kernel family runs: the one routing table.

Every choice between a hand-written kernel and its plain-XLA version is
made here, from the JAX platform and static shapes only (no environment
variables).  The GPU kernels go through Pallas's Triton route
(ops/pallas_decode.py, ops/xxh32_device.py); every other platform runs
the plain XLA versions, which are also the references the kernels are
tested against.  Bit packing and frame assembly are plain XLA on every
platform (ops/bitpack.py, ops/encode.py).

Tests that need another path monkeypatch these functions; production
code never passes ``interpret=True``.
"""

from __future__ import annotations

import jax

__all__ = ["platform", "decode_path", "checksum_path", "assemble_path"]


def platform() -> str:
    """The JAX default backend's platform name ("cpu", "gpu", ...)."""
    return jax.default_backend()


def decode_path(platform: str) -> str:
    """Lockstep Golomb decoder: ``"triton"`` kernel or ``"xla"`` scan.

    The XLA scan runs one dispatch chain per sample step; on the GPU the
    Triton kernel keeps the whole serial loop inside one launch, for any
    batch size and sample count.
    """
    return "triton" if platform == "gpu" else "xla"


def checksum_path(platform: str, n_samples: int) -> str:
    """Per-block XXH32 of (B, N) samples: ``"triton"``, ``"xla"`` or
    ``"host"``.

    The Triton kernel needs whole 16-byte stripes (N % 8 == 0); other N
    on the GPU take the XLA stripe scan.  Off the GPU the checksums are
    computed on the host (native xxhash when available), where they
    cost less than an interpreted or CPU-compiled scan.
    """
    if platform != "gpu":
        return "host"
    if n_samples >= 8 and n_samples % 8 == 0:
        return "triton"
    return "xla"


def assemble_path(platform: str) -> str:
    """``BatchCompressor.compress_frames_packed(assemble="auto")``:
    ``"host"`` (native row gather over the fetched frame matrix) or
    ``"device"`` (funnel-shift merge tree, fetch the trimmed stream).

    On the GPU the two measured within a few percent of each other end to
    end at B=512, N=8192, the device merge ahead in two runs of three
    (chip_smoke.py phase 7; PERF.md); the CPU gathers on host.
    """
    return "device" if platform == "gpu" else "host"
