"""Code construction: frozen-bit selection, host-side NumPy (copies of
polar_codes_tpu/construction/)."""

from .core import (
    Construction,
    frozen_bits,
    frozen_bit_mask,
    info_indices,
    split_frozen_bits,
)
from .bhattacharyya import bhattacharyya_parameters, bhattacharyya_frozen_bits
from .betaexpansion import beta_expansion_weights, beta_expansion_frozen_bits
from .fiveg import nr_frozen_bits, nr_reliability_sequence
from .gaussian import (
    gaussian_approximation_llr_means,
    gaussian_approximation_frozen_bits,
)
from .densityevolution import (
    tal_vardy_error_probabilities,
    tal_vardy_frozen_bits,
    aff3ct_frozen_bits,
    density_evolution_frozen_bits,
)

__all__ = [
    "Construction",
    "frozen_bits",
    "frozen_bit_mask",
    "info_indices",
    "split_frozen_bits",
    "bhattacharyya_parameters",
    "bhattacharyya_frozen_bits",
    "beta_expansion_weights",
    "beta_expansion_frozen_bits",
    "nr_frozen_bits",
    "nr_reliability_sequence",
    "gaussian_approximation_llr_means",
    "gaussian_approximation_frozen_bits",
    "tal_vardy_error_probabilities",
    "tal_vardy_frozen_bits",
    "aff3ct_frozen_bits",
    "density_evolution_frozen_bits",
]
