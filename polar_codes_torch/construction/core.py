"""Construction front-end: the `frozen_bits` factory and the mask helpers.

A copy of polar_codes_tpu/construction/core.py: string-keyed dispatch by
case-insensitive substring, "BB" by default.
"""

from __future__ import annotations

import enum
from typing import Sequence, Tuple

import numpy as np

from .betaexpansion import beta_expansion_frozen_bits
from .bhattacharyya import bhattacharyya_frozen_bits
from .densityevolution import density_evolution_frozen_bits
from .fiveg import nr_frozen_bits
from .gaussian import gaussian_approximation_frozen_bits


class Construction(enum.Enum):
    BHATTACHARYYA = "BB"
    BETA_EXPANSION = "BE"
    FIVE_G = "5G"
    GAUSSIAN_APPROXIMATION = "GA"
    DENSITY_EVOLUTION = "DE"


def frozen_bits(
    block_length: int,
    info_length: int,
    design_snr_db: float = 0.0,
    constructor_type: str = "BB",
) -> np.ndarray:
    """Select frozen-bit positions; returns sorted int64 positions.

    Dispatch by substring, case-insensitive, in this order: "be", "5g",
    "ga", "de" or "tv", else BB."""
    ctype = constructor_type.lower()
    if "be" in ctype:
        fn = beta_expansion_frozen_bits
    elif "5g" in ctype:
        fn = nr_frozen_bits
    elif "ga" in ctype:
        fn = gaussian_approximation_frozen_bits
    elif "de" in ctype or "tv" in ctype:
        fn = density_evolution_frozen_bits
    else:
        fn = bhattacharyya_frozen_bits
    return fn(block_length, info_length, design_snr_db)


def frozen_bit_mask(block_length: int, frozen: Sequence[int]) -> np.ndarray:
    """Boolean mask of length N, True at frozen positions."""
    mask = np.zeros(block_length, dtype=bool)
    frozen = np.asarray(frozen, dtype=np.int64)
    if frozen.size:
        if frozen.min() < 0 or frozen.max() >= block_length:
            raise ValueError("frozen position out of range")
        mask[frozen] = True
    return mask


def info_indices(block_length: int, frozen: Sequence[int]) -> np.ndarray:
    """Sorted information (non-frozen) positions."""
    return np.flatnonzero(~frozen_bit_mask(block_length, frozen)).astype(np.int64)


def split_frozen_bits(
    frozen: Sequence[int], boundary: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a sorted frozen set at `boundary` into (left, right rebased):
    positions < boundary stay, positions >= boundary move by -boundary."""
    frozen = np.asarray(frozen, dtype=np.int64)
    left = frozen[frozen < boundary]
    right = frozen[frozen >= boundary] - boundary
    return left, right
