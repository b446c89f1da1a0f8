"""Beta-expansion ("BE") / polarization-weight construction.

A copy of polar_codes_tpu/construction/betaexpansion.py:
w(i) = sum_j bit_j(i) * beta^j with beta = 2^(1/4); the N-K channels with
the *smallest* weights are frozen (ascending argsort, first N-K).
"""

from __future__ import annotations

import numpy as np

BETA = 2.0 ** 0.25


def beta_expansion_weights(block_length: int, beta: float = BETA) -> np.ndarray:
    """Polarization weights w(i) = sum_j bit_j(i) * beta^j (betaexpansion.cpp:62-78)."""
    n = block_length.bit_length() - 1
    if (1 << n) != block_length:
        raise ValueError(f"block length {block_length} is not a power of 2")
    i = np.arange(block_length, dtype=np.uint64)
    bits = ((i[:, None] >> np.arange(n, dtype=np.uint64)[None, :]) & 1).astype(
        np.float64
    )
    weights = bits @ (beta ** np.arange(n, dtype=np.float64))
    return weights


def beta_expansion_frozen_bits(
    block_length: int, info_length: int, design_snr_db: float = 0.0
) -> np.ndarray:
    """Frozen positions: N-K smallest-weight channels, sorted ascending.

    design_snr_db is accepted for factory-signature parity but unused, as in
    the reference (betaexpansion.cpp ignores the design SNR).
    """
    if block_length < info_length:
        raise ValueError(f"invalid polar code ({block_length}, {info_length})")
    w = beta_expansion_weights(block_length)
    order = np.argsort(w, kind="stable")
    frozen = np.sort(order[: block_length - info_length])
    return frozen.astype(np.int64)
