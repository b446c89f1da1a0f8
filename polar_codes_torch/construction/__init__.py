"""Code construction: frozen-bit selection, host-side NumPy."""

from .core import frozen_bits, frozen_bit_mask, info_indices
from .bhattacharyya import bhattacharyya_parameters, bhattacharyya_frozen_bits

__all__ = [
    "frozen_bits",
    "frozen_bit_mask",
    "info_indices",
    "bhattacharyya_parameters",
    "bhattacharyya_frozen_bits",
]
