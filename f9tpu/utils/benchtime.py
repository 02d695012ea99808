"""Host-clock device timing.

JAX dispatches asynchronously, so a timed region must end in
``block_until_ready``; `measure_op` warms the op up (compiling it) first and
reports the median steady-state time per call.
"""

from __future__ import annotations

import time
from typing import Callable

import jax

__all__ = ["measure_op"]


def measure_op(
    op: Callable,
    x: jax.Array,
    n: int = 16,
    repeats: int = 3,
) -> float:
    """Median seconds per ``op(x)`` call: ``repeats`` groups of ``n``
    back-to-back calls, each group timed on the host clock up to
    ``block_until_ready`` of its last result, after one warm-up call."""
    fn = jax.jit(op)
    jax.block_until_ready(fn(x))
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            y = fn(x)
        jax.block_until_ready(y)
        samples.append((time.perf_counter() - t0) / n)
    samples.sort()
    mid = len(samples) // 2
    if len(samples) % 2 == 0:
        return 0.5 * (samples[mid - 1] + samples[mid])
    return samples[mid]
