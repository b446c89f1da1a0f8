"""Gaussian-approximation (GA) construction, Dai et al. variant.

A copy of polar_codes_tpu/construction/gaussian.py, float64 NumPy/scipy in
the same operation order (a reordered sum can move a channel across the K
boundary): it tracks the mean of the all-zero-codeword LLR under
BPSK/AWGN through the polar transform using the 4-segment phi
approximation from

  Dai et al., "Does Gaussian Approximation Work Well for the Long-Length
  Polar Code Construction?", IEEE Access 2017.
"""

from __future__ import annotations

import numpy as np
from scipy import special as sps


def _phi4(t: np.ndarray) -> np.ndarray:
    """4-segment approximation of phi(t) = 1 - E[tanh(L/2)] for L~N(t, 2t)."""
    t = np.asarray(t, dtype=np.float64)
    # clamp per-branch arguments so the unselected np.where branches
    # cannot overflow (branches are evaluated eagerly)
    t_small = np.minimum(t, 10.0)
    return np.where(
        t <= 0.1910,
        np.exp(0.1047 * t_small * t_small - 0.4992 * t_small),
        np.where(
            t <= 0.7420,
            0.9981 * np.exp(0.05315 * t_small * t_small - 0.4795 * t_small),
            np.where(
                t <= 9.2254,
                np.exp(-0.4527 * np.power(np.maximum(t, 1e-300), 0.86) + 0.0218),
                np.exp(-0.2832 * t - 0.4254),
            ),
        ),
    )


def _inv_quad_exp(y: np.ndarray, a: float, b: float, r: float) -> np.ndarray:
    return (b - np.sqrt(4.0 * a * np.log(np.maximum(y, 1e-300) / r) + b * b)) / (
        2.0 * a
    )


def _phi4_inv(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, dtype=np.float64)
    ainv = 0.9125360939445893
    binv = 0.7200545321883631
    cinv = 0.047929057387273905
    tc = np.maximum(t, 1e-300)
    return np.where(
        t >= 1.0,
        0.0,
        np.where(
            t > ainv,
            _inv_quad_exp(tc, a=0.1047, b=0.4992, r=1.0),
            np.where(
                t > binv,
                _inv_quad_exp(tc, a=0.05315, b=0.4795, r=0.9981),
                np.where(
                    t > cinv,
                    np.power((0.0218 - np.log(tc)) / 0.4527, 1.0 / 0.86),
                    -(np.log(tc) + 0.4254) / 0.2832,
                ),
            ),
        ),
    )


def _check_node(t: np.ndarray) -> np.ndarray:
    """f_c(t): mean LLR out of a check (upper) branch."""
    tau = 11.673
    safe = _phi4_inv(1.0 - (1.0 - _phi4(t)) ** 2)
    return np.where(t > tau, t - 2.4476, safe)


def gaussian_approximation_llr_means(
    block_length: int, design_snr_db: float
) -> np.ndarray:
    """Mean LLR of each synthetic channel under GA.

    Initial mean = 2 * 10^(snr/10) (channel_construction.py:24,216), then the
    density-evolution recursion: check branch f_c, variable branch f_v = 2t.
    """
    m = block_length.bit_length() - 1
    if (1 << m) != block_length:
        raise ValueError(f"block length {block_length} is not a power of 2")
    z = np.full(1, 2.0 * 10.0 ** (design_snr_db / 10.0), dtype=np.float64)
    for _ in range(m):
        z = np.stack([_check_node(z), 2.0 * z], axis=-1).reshape(-1)
    return z


def gaussian_approximation_frozen_bits(
    block_length: int, info_length: int, design_snr_db: float = 0.0
) -> np.ndarray:
    """Frozen positions: N-K channels with the smallest GA capacity, sorted.

    Capacity proxy = erf(sqrt(mean/2)) as in the reference (:165), frozen =
    argsort ascending first N-K (ChannelConstructor.frozenBitPositions).
    """
    means = gaussian_approximation_llr_means(block_length, design_snr_db)
    capacities = sps.erf(np.sqrt(means / 2.0))
    order = np.argsort(capacities, kind="stable")
    frozen = np.sort(order[: block_length - info_length])
    return frozen.astype(np.int64)
