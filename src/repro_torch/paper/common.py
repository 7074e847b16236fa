"""Shared helpers of the paper's experiments (port of
``benchmarks/common.py``): ``emit`` prints a ``name,us_per_call,derived``
row under the reference's names, so the two outputs can be set side by
side; ``time_fn`` is a host wall-clock timer that waits for the device.
Its times are the host's view of one call, not a benchmark."""
from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


def emit(name: str, us_per_call: float, derived: str
         ) -> Tuple[str, float, str]:
    """Print one row and return it."""
    print(f"{name},{us_per_call:.3f},{derived}")
    return name, us_per_call, derived


def sync() -> None:
    """Wait for the CUDA device, when one is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median wall time per call in microseconds, each call ended by a
    device synchronisation."""
    for _ in range(warmup):
        fn(*args)
        sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6
