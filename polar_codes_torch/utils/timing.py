"""Device timing on the card with CUDA events.

Each repeat records an event before and after one call on the current
stream and reads the elapsed device time; the result is the median over
the repeats, after warm-up calls that build kernels and fill caches.
Timing needs a card: with none, it raises instead of timing the CPU.
"""

from __future__ import annotations

import statistics
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
