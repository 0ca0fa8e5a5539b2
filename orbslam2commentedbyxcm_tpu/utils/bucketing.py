"""Shape bucketing: pad variable-size device inputs to power-of-two buckets.

Every distinct input shape costs one XLA compilation. Host code that feeds
the device with whatever-length arrays (loop-closing matches, pose-graph
sizes, candidate sets) compiles hundreds of near-identical programs over a
run — slow everywhere and fatal on XLA:CPU, whose LLVM JIT
exhausts process memory maps after enough programs. All variable-size call
sites pad to `bucket(n)` with an explicit validity mask instead.
"""

from __future__ import annotations

import numpy as np


def bucket(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def pad_rows(arr: np.ndarray, n: int, fill=0):
    """Pad axis 0 of `arr` up to n rows with `fill`."""
    if len(arr) >= n:
        return arr[:n]
    pad_shape = (n - len(arr),) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])


def pad_mask(n_valid: int, n_total: int) -> np.ndarray:
    m = np.zeros(n_total, bool)
    m[:n_valid] = True
    return m
