"""Tracing/profiling/observability utilities.

The reference has no tracing beyond verbose logging (SURVEY §5); the
equivalents here are:

* :class:`StageTimer` — wall-clock stage timers with ``block_until_ready``
  barriers, accumulating per-stage totals and GB/s;
* :func:`trace` — context manager bridging to ``jax.profiler`` traces
  (view with TensorBoard / xprof);
* :class:`ThroughputMeter` — rolling encode/decode byte counters used by
  the batched pipelines' ``metrics`` property.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["StageTimer", "ThroughputMeter", "trace"]


class StageTimer:
    """Accumulating per-stage wall timers (device-synchronized)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.bytes: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.bytes[name] = self.bytes.get(name, 0) + nbytes

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            b = self.bytes[name]
            rate = f", {b / total / 1e9:.2f} GB/s" if b and total else ""
            lines.append(f"{name}: {total * 1e3:.2f} ms / {n} calls"
                         f" ({total / n * 1e3:.3f} ms avg{rate})")
        return "\n".join(lines)


class ThroughputMeter:
    """Rolling byte/time counters for pipeline observability."""

    def __init__(self) -> None:
        self.bytes_in = 0
        self.bytes_out = 0
        self.seconds = 0.0
        self.calls = 0

    def record(self, bytes_in: int, bytes_out: int, seconds: float) -> None:
        self.bytes_in += bytes_in
        self.bytes_out += bytes_out
        self.seconds += seconds
        self.calls += 1

    @property
    def gbps(self) -> float:
        return self.bytes_in / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def ratio(self) -> float:
        return self.bytes_in / self.bytes_out if self.bytes_out else 0.0

    def as_dict(self) -> dict:
        return {"bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "seconds": self.seconds, "calls": self.calls,
                "gbps": self.gbps, "ratio": self.ratio}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (open the result with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
