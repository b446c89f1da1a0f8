"""The port's density-evolution (native Tal-Vardy) construction against the
JAX package's, at the JAX default mu = 128: frozen sets and the channels'
error probabilities equal (both are float64 NumPy in the same operation
order). No aff3ct table is in the repo, so AFF3CT_TV_PATH is unset.

The pure-Python degrading merge costs ~12 s a package at N = 256, so two
of the three N = 256 points are marked slow."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_tpu.construction import frozen_bits as jax_frozen_bits  # noqa: E402
from polar_codes_tpu.construction import (  # noqa: E402
    tal_vardy_error_probabilities as jax_tal_vardy_error_probabilities)

from polar_codes_torch.construction import (  # noqa: E402
    frozen_bits, tal_vardy_error_probabilities)

SLOW = pytest.mark.slow

POINTS = [(n, snr) for n in (16, 64) for snr in (-1.0, 0.0, 2.5)] + [
    (256, 0.0), pytest.param(256, -1.0, marks=SLOW), pytest.param(256, 2.5, marks=SLOW)]


@pytest.mark.parametrize("n,snr", POINTS)
def test_density_evolution_frozen_bits_equal(n, snr, monkeypatch):
    monkeypatch.delenv("AFF3CT_TV_PATH", raising=False)
    got = frozen_bits(n, n // 2, snr, "DE")
    np.testing.assert_array_equal(got, jax_frozen_bits(n, n // 2, snr, "DE"))
    assert got.size == n // 2
    np.testing.assert_array_equal(tal_vardy_error_probabilities(n, snr),
                                  jax_tal_vardy_error_probabilities(n, snr))
