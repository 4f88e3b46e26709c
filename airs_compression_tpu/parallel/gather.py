"""Ordered gather of variable-length compressed blocks (multi-host ready).

An AIRSPACE stream is a concatenation of self-delimiting blocks, so
distributed assembly needs only (a) every block's actual size and (b) a
deterministic stream order — block index order (SURVEY §2.5/§5).

Single-process multi-device: the encoder's fixed-capacity word buffers and
sizes are already globally addressable; assembly is host-side slicing.
Multi-host: each host holds its shard of the block axis; sizes travel
through ``multihost_utils.process_allgather`` (the host network), then every host (or
just host 0) assembles its portion and rank-orders the result.  Payload
bytes move host-to-host only when a single output file is required — the
normal production path writes per-host shards with a manifest instead.
"""

from __future__ import annotations

import numpy as np

import jax

__all__ = ["assemble_stream", "allgather_sizes", "StreamManifest"]


def assemble_stream(words, sizes, swapped: bool = False) -> bytes:
    """Concatenate per-block frames from device output, in block order.

    ``words``: (B, W) uint32 device/host array (big-endian word streams),
    ``sizes``: (B,) actual byte sizes.  Returns the contiguous stream.
    The extraction is one native C row gather (with a pure-numpy
    fallback) instead of a per-block Python slice loop; pass
    ``swapped=True`` when the words were already byte-swapped on device
    (models/stream.bswap32) to skip the host byteswap pass entirely.
    """
    import sys

    words_np = np.ascontiguousarray(words)
    sizes_np = np.asarray(sizes)
    if not swapped and sys.byteorder == "little":
        words_np = words_np.byteswap()
    rows = words_np.view(np.uint8).reshape(words_np.shape[0], -1)
    from .. import native

    if native.native_available():
        return native.gather_rows(rows, sizes_np, rows.shape[1])
    out = bytearray()
    for b in range(rows.shape[0]):
        out += rows[b, : int(sizes_np[b])].tobytes()
    return bytes(out)


def allgather_sizes(local_sizes: np.ndarray) -> np.ndarray:
    """All-gather per-block sizes across hosts (no-op single-process).

    Returns the flat global size vector in block order (process-major:
    process 0's blocks first), matching StreamManifest's stream order.
    """
    if jax.process_count() == 1:
        return np.asarray(local_sizes)
    from jax.experimental import multihost_utils

    stacked = np.asarray(multihost_utils.process_allgather(
        np.asarray(local_sizes)))
    return stacked.reshape(-1)


class StreamManifest:
    """Order-preserving manifest of a distributed stream.

    Records (process, local_block_index, size) in global stream order so
    per-host shard files can later be spliced into one AIRSPACE stream
    without moving payload bytes through a single host during encode.
    """

    def __init__(self, blocks_per_process: "list[int]", sizes: np.ndarray):
        self.blocks_per_process = list(blocks_per_process)
        self.sizes = np.asarray(sizes)

    def global_order(self):
        """Yields (process, local_index, size) in stream order."""
        i = 0
        for p, nb in enumerate(self.blocks_per_process):
            for j in range(nb):
                yield p, j, int(self.sizes[i])
                i += 1

    @property
    def total_bytes(self) -> int:
        return int(self.sizes.sum())
