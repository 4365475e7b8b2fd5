"""Tracing / profiling helpers (SURVEY.md §5.1).

The reference's only instrumentation is the ``rate`` pipe and Criterion
(SDR/PipeUtils.hs:40-55); on the accelerator the native tool is the XLA profiler.
``trace`` wraps stages in named annotations visible in the trace viewer;
``profile`` captures a full device trace around a callable.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax

__all__ = ["trace", "profile", "timed"]


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """Named region in the device profile (jax.profiler.TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile(logdir: str) -> Iterator[None]:
    """Capture a device trace to ``logdir`` (view with tensorboard or
    xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, sink=print) -> Iterator[None]:
    """Wall-clock a region with device sync at exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (jax.device_put(0.0) + 0).block_until_ready()
        sink(f"{label}: {time.perf_counter() - t0:.4f}s")
