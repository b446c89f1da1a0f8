"""Bhattacharyya-bound ("BB") construction, host-side NumPy.

A copy of polar_codes_tpu/construction/bhattacharyya.py: initial parameter
z = exp(-2 * 10^(designSNR/10) * K / N), the stage recursion
z_even <- 2z - z^2, z_odd <- z^2, and the N-K least reliable channels
(largest z, ties to the lowest index, compared in float32) frozen.
"""

from __future__ import annotations

import numpy as np


def bhattacharyya_initial_parameter(n: int, k: int, design_snr_db: float) -> float:
    """eta = exp(-2 * snr_linear * K / N)."""
    snr_linear = 10.0 ** (design_snr_db / 10.0)
    return float(np.exp(-2.0 * snr_linear * k / n))


def bhattacharyya_parameters(block_length: int, initial: float) -> np.ndarray:
    """Per-channel Bhattacharyya parameters via the Arikan recursion."""
    n = block_length.bit_length() - 1
    if (1 << n) != block_length:
        raise ValueError(f"block length {block_length} is not a power of 2")
    z = np.empty(block_length, dtype=np.float64)
    z[0] = initial
    for stage in range(n - 1, -1, -1):
        b = 1 << stage
        step = b << 1
        t = z[0:block_length:step].copy()
        z[b::step] = t * t
        z[0:block_length:step] = 2.0 * t - t * t
    return z


def bhattacharyya_frozen_bits(
    block_length: int, info_length: int, design_snr_db: float = 0.0
) -> np.ndarray:
    """Frozen positions (sorted ascending): stable descending sort of the
    float32 channel parameters, the first N-K frozen."""
    initial = bhattacharyya_initial_parameter(block_length, info_length, design_snr_db)
    z = bhattacharyya_parameters(block_length, initial).astype(np.float32)
    order = np.argsort(-z, kind="stable")
    frozen = np.sort(order[: block_length - info_length])
    return frozen.astype(np.int64)
