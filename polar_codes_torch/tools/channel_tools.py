"""Noise calibration helpers, a copy of polar_codes_tpu/tools/channel_tools.py."""

from __future__ import annotations

import numpy as np


def ebn0_to_sigma(
    ebn0_db, coderate: float, constellation_order: float = 1.0
) -> float:
    """Noise std dev for unit symbol energy (channel_simulation.py:13-19)."""
    rate = constellation_order * coderate
    snr_lin = 10.0 ** (np.asarray(ebn0_db) / 10.0) * rate
    return np.sqrt(1.0 / snr_lin)


def sigma_to_ebn0(
    sigma, coderate: float, constellation_order: float = 1.0
) -> float:
    rate = constellation_order * coderate
    return 10.0 * np.log10(1.0 / (np.asarray(sigma) ** 2 * rate))


def ebn0_to_esn0_linear(
    ebn0_db, coderate: float, bits_per_symbol: int = 1
) -> float:
    """Es/N0 = Eb/N0 * R * bps (the simulator's channel setup)."""
    return 10.0 ** (np.asarray(ebn0_db) / 10.0) * coderate * bits_per_symbol
