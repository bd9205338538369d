"""Tracing and timing hooks (mrfp_tpu/utils/profiling.py).

``trace_ctx`` records a ``torch.profiler`` trace of the host and the card
into a directory (a Chrome trace, for Perfetto or chrome://tracing);
``step_timer`` measures a call's steady-state time on the host clock,
synchronising the card before it reads the clock, since PyTorch returns
before the device finishes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace_ctx(logdir: Optional[str]):
    """torch.profiler trace scope (CPU, and CUDA where present) written to
    ``logdir/trace.json``; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def step_timer(step_fn: Callable, *args, iters: int = 10, warmup: int = 2,
               fetch: Optional[Callable] = None) -> float:
    """Seconds per call, steady state: ``warmup`` calls, then ``iters``
    timed ones, the card synchronised before each clock read. ``fetch(result)``
    is called on the last result of each phase (e.g. to pull a scalar to
    the host, as the JAX timer must)."""
    result = None
    for _ in range(warmup):
        result = step_fn(*args)
    if fetch:
        fetch(result)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        result = step_fn(*args)
    if fetch:
        fetch(result)
    _sync()
    return (time.perf_counter() - t0) / iters
