"""AWGN channel, as in polar_codes_tpu/dsp/channel.py, with the noise drawn
from a caller's torch.Generator on the signal's device (jax.random keys
become generators; the two give different numbers from one seed).
Rayleigh and Scale are not ported yet."""

from __future__ import annotations

import math
from typing import Optional

import torch


def awgn_sigma(esn0_db: Optional[float] = None,
               esn0_linear: Optional[float] = None) -> float:
    """Noise std dev of a real channel: 1/sqrt(2 Es/N0)."""
    if esn0_linear is None:
        esn0_linear = 10.0 ** (esn0_db / 10.0)
    return 1.0 / math.sqrt(2.0 * esn0_linear)


def add_awgn(signal: torch.Tensor, generator: torch.Generator,
             esn0_db: Optional[float] = None,
             esn0_linear: Optional[float] = None) -> torch.Tensor:
    """signal + N(0, sigma^2), the noise drawn from `generator`, which must
    live on the signal's device."""
    sigma = awgn_sigma(esn0_db, esn0_linear)
    noise = torch.randn(signal.shape, generator=generator, dtype=torch.float32,
                        device=signal.device)
    return signal + sigma * noise


class Awgn:
    def __init__(self, esn0_db: float = 5.0):
        self.set_esn0_db(esn0_db)

    def set_esn0_db(self, esn0_db: float):
        self.esn0_db = float(esn0_db)
        self.esn0_linear = 10.0 ** (self.esn0_db / 10.0)

    def set_esn0_linear(self, esn0_linear: float):
        self.esn0_linear = float(esn0_linear)
        self.esn0_db = 10.0 * math.log10(self.esn0_linear)

    def transmit(self, signal: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return add_awgn(signal, generator, esn0_linear=self.esn0_linear)
