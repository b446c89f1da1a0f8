"""Host-side analysis and construction tools, NumPy copies of
polar_codes_tpu/tools/ on the port's construction and code tree: GF(2)
matrices and bit-reversal helpers, 5G NR rate matching, frozen-bit
strategy classes, noise calibration, and the decoder tree as text or a
figure. The JAX package's results readers (analysis.py, report.py) read
its benchmark's JSONL and are not ported."""

from .code_tools import (
    polar_generator_matrix,
    systematic_encoder_matrix,
    bit_reverse,
    bit_reversed_vector,
    frozen_indices_to_map,
    info_indices_from_frozen,
)
from .fiveg_tools import (
    nr_subblock_interleave,
    nr_rate_match,
    nr_rate_recover,
)
from .strategies import (
    FrozenBitPositions,
    FrozenBitPositionsBB,
    FrozenBitPositionsBE,
    FrozenBitPositionsGA,
    FrozenBitPositions5G,
    get_frozen_bit_generator,
)
from .channel_tools import ebn0_to_sigma, sigma_to_ebn0, ebn0_to_esn0_linear
from .visualize import render_tree_text, render_tree_figure

__all__ = [
    "polar_generator_matrix",
    "systematic_encoder_matrix",
    "bit_reverse",
    "bit_reversed_vector",
    "frozen_indices_to_map",
    "info_indices_from_frozen",
    "nr_subblock_interleave",
    "nr_rate_match",
    "nr_rate_recover",
    "FrozenBitPositions",
    "FrozenBitPositionsBB",
    "FrozenBitPositionsBE",
    "FrozenBitPositionsGA",
    "FrozenBitPositions5G",
    "get_frozen_bit_generator",
    "ebn0_to_sigma",
    "sigma_to_ebn0",
    "ebn0_to_esn0_linear",
    "render_tree_text",
    "render_tree_figure",
]
