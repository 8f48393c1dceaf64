"""Tracing/profiling (SURVEY.md SS5.1): jax.profiler capture + MLUPS.

The reference times with printf/cudaEvent; here `trace()` wraps a code
region in a jax.profiler capture (Perfetto/XProf-readable; reduce it to
kernels per step and device busy time with utils.device.kernel_stats),
and `Timer` gives wall timings that wait for the device.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace viewable with XProf/TensorBoard:
    `with profiling.trace('/tmp/trace'): sim.run(100)`."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Region timer: `with Timer() as t: ...`; t.seconds after the
    block. Pass a pytree via sync= to wait for it on the device."""

    def __init__(self, sync=None):
        self._sync = sync
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            jax.block_until_ready(self._sync)
        self.seconds = time.perf_counter() - self._t0
        return False


def mlups(nx: int, ny: int, steps: int, seconds: float) -> float:
    """Million lattice-site updates per second - the domain's headline
    throughput metric (SURVEY SS6)."""
    return nx * ny * steps / seconds / 1e6
