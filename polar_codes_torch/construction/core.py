"""Construction front-end: `frozen_bits` and the mask helpers.

Mirrors polar_codes_tpu/construction/core.py. Only the Bhattacharyya ("BB")
construction is ported so far; the other methods raise NotImplementedError
instead of silently falling back to BB.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .bhattacharyya import bhattacharyya_frozen_bits


def frozen_bits(
    block_length: int,
    info_length: int,
    design_snr_db: float = 0.0,
    constructor_type: str = "BB",
) -> np.ndarray:
    """Select frozen-bit positions; returns sorted int64 positions.

    The same case-insensitive substring dispatch as the JAX package, whose
    default is BB."""
    ctype = constructor_type.lower()
    for key in ("be", "5g", "ga", "de", "tv"):
        if key in ctype:
            raise NotImplementedError(
                f"construction {constructor_type!r} is not ported yet; "
                "only 'BB' is"
            )
    return bhattacharyya_frozen_bits(block_length, info_length, design_snr_db)


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
