"""Device mesh helpers.

The framework scales over a 1-D ``dp`` (data-parallel/block) axis, with an
optional ``sp`` (sequence/stream-parallel) axis for splitting one very long
sample stream across chips (the codec's analog of context parallelism; see
parallel/sp.py).  The reference is strictly single-threaded single-process
(SURVEY §2.5); distribution here is a new capability designed around XLA
collectives (NCCL over NVLink between the GPUs of one host).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "block_sharding", "P", "NamedSharding"]


def make_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def block_sharding(mesh: Mesh, axis_name: str = "dp") -> NamedSharding:
    """Shard the leading (block) axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def multihost_initialize(**kwargs) -> None:
    """Initialize the multi-host runtime (jax.distributed).

    Every host runs the same program; collectives ride NVLink between
    the GPUs of one host and the network between hosts.  No-op if
    already initialized.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized
