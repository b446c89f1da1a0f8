"""Frozen-bit strategy classes, a copy of
polar_codes_tpu/tools/strategies.py on the port's construction: each
strategy wraps one construction algorithm behind `frozen_bit_positions()`
and `info_bit_positions()`, and `get_frozen_bit_generator` picks one by
name.
"""

from __future__ import annotations

import numpy as np

from ..construction import (
    bhattacharyya_frozen_bits,
    beta_expansion_frozen_bits,
    gaussian_approximation_frozen_bits,
    nr_frozen_bits,
)
from ..construction.densityevolution import density_evolution_frozen_bits


class FrozenBitPositions:
    """Strategy base (frozen_bit_positions.py:23-37)."""

    def __init__(self, block_length: int, info_length: int, dSNR: float = 0.0):
        self.block_length = int(block_length)
        self.info_length = int(info_length)
        self.design_snr = float(dSNR)
        self._frozen = None

    def _generate(self) -> np.ndarray:
        raise NotImplementedError

    def frozen_bit_positions(self) -> np.ndarray:
        if self._frozen is None:
            self._frozen = np.sort(np.asarray(self._generate(), np.int64))
        return self._frozen

    def info_bit_positions(self) -> np.ndarray:
        return np.setdiff1d(
            np.arange(self.block_length, dtype=np.int64),
            self.frozen_bit_positions(),
        )


class FrozenBitPositionsBB(FrozenBitPositions):
    def _generate(self):
        return bhattacharyya_frozen_bits(
            self.block_length, self.info_length, self.design_snr
        )


class FrozenBitPositionsBE(FrozenBitPositions):
    def _generate(self):
        return beta_expansion_frozen_bits(self.block_length, self.info_length)


class FrozenBitPositionsGA(FrozenBitPositions):
    def _generate(self):
        return gaussian_approximation_frozen_bits(
            self.block_length, self.info_length, self.design_snr
        )


class FrozenBitPositions5G(FrozenBitPositions):
    def _generate(self):
        return nr_frozen_bits(self.block_length, self.info_length)


class FrozenBitPositionsDE(FrozenBitPositions):
    """Tal-Vardy density evolution (construction/densityevolution.py; an
    aff3ct table is read instead where $AFF3CT_TV_PATH names one)."""

    def _generate(self):
        return density_evolution_frozen_bits(
            self.block_length, self.info_length, self.design_snr
        )


_STRATEGIES = {
    "DE": FrozenBitPositionsDE,
    "BB": FrozenBitPositionsBB,
    "GA": FrozenBitPositionsGA,
    "BE": FrozenBitPositionsBE,
    "PW": FrozenBitPositionsBE,  # polarization weight == beta expansion
    "5G": FrozenBitPositions5G,
}


def get_frozen_bit_generator(
    kind: str, block_length: int, info_length: int, dSNR: float = 0.0
) -> FrozenBitPositions:
    """Strategy factory (frozen_bit_positions.py get_frozen_bit_generator)."""
    key = kind.upper()
    for name, cls in _STRATEGIES.items():
        if name in key:
            return cls(block_length, info_length, dSNR)
    raise ValueError(f"unknown frozen-bit strategy: {kind}")
