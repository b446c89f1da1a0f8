"""Device timing on the card with CUDA events.

Each repeat records an event before and after one call on the current
stream and reads the elapsed device time; the result is the median over
the repeats, after warm-up calls that build kernels and fill caches.
time_cuda needs a card: with none, it raises instead of timing the CPU.
time_on times the device its caller names, the host clock for the CPU.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def time_cuda(fn: Callable[[], object], warmup: int = 3, reps: int = 10) -> float:
    """Median milliseconds of one call of fn() on the current CUDA stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def time_on(device, fn: Callable[[], object], warmup: int = 3, reps: int = 10) -> float:
    """Median milliseconds of one call of fn() on the device the caller runs
    on: CUDA events on a card (time_cuda), the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        return time_cuda(fn, warmup=warmup, reps=reps)
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)
