"""Channels: AWGN, Rayleigh fading and a constant Scale, as in
polar_codes_tpu/dsp/channel.py.

The random draws come from a caller's torch.Generator on the signal's
device (jax.random keys become generators; the two give different numbers
from one seed). Each channel splits into its draws and a pure function of
them (`awgn_from`, `rayleigh_from`), which computes in float32 in the JAX
package's operation order, so the same draws give the same samples in
both packages.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _esn0(esn0_db: Optional[float], esn0_linear: Optional[float]) -> float:
    return 10.0 ** (esn0_db / 10.0) if esn0_linear is None else esn0_linear


def awgn_sigma(esn0_db: Optional[float] = None,
               esn0_linear: Optional[float] = None) -> float:
    """Noise std dev of a real channel: 1/sqrt(2 Es/N0)."""
    return 1.0 / math.sqrt(2.0 * _esn0(esn0_db, esn0_linear))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device (through
    float64, which is exact here: torch.sqrt on an AVX-512 CPU is not)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def awgn_from(signal: torch.Tensor, noise: torch.Tensor,
              esn0_linear: float) -> torch.Tensor:
    """signal + sigma * noise with sigma = 1/sqrt(2 Es/N0) in float32."""
    es = torch.tensor(esn0_linear, dtype=torch.float32, device=signal.device)
    sigma = 1.0 / _sqrt(2.0 * es)
    return signal + sigma * noise


def rayleigh_from(signal: torch.Tensor, fade: torch.Tensor, noise: torch.Tensor,
                  esn0_linear: float) -> torch.Tensor:
    """|h| x + sigma * noise, h = g1 + j g2 from fade [..., 2] ~ N(0, 1),
    sigma = 1/sqrt(Es/N0), in float32, each operation rounded (as the JAX
    formula runs op by op; XLA's CPU backend, compiling the simulator's
    whole chain, contracts the sum of squares into an FMA, which moves the
    fade by up to one ulp)."""
    es = torch.tensor(esn0_linear, dtype=torch.float32, device=signal.device)
    h = _sqrt(torch.sum(fade * fade, dim=-1))
    sigma = 1.0 / _sqrt(es)
    return signal * h + sigma * noise


def add_awgn(signal: torch.Tensor, generator: torch.Generator,
             esn0_db: Optional[float] = None,
             esn0_linear: Optional[float] = None) -> torch.Tensor:
    """signal + N(0, sigma^2), the noise drawn from `generator`, which must
    live on the signal's device."""
    noise = torch.randn(signal.shape, generator=generator, dtype=torch.float32,
                        device=signal.device)
    return awgn_from(signal, noise, _esn0(esn0_db, esn0_linear))


def apply_rayleigh(signal: torch.Tensor, generator: torch.Generator,
                   esn0_db: Optional[float] = None,
                   esn0_linear: Optional[float] = None) -> torch.Tensor:
    """Rayleigh fading and AWGN: the fade draws [..., 2], then the noise,
    from `generator`."""
    fade = torch.randn(signal.shape + (2,), generator=generator,
                       dtype=torch.float32, device=signal.device)
    noise = torch.randn(signal.shape, generator=generator, dtype=torch.float32,
                        device=signal.device)
    return rayleigh_from(signal, fade, noise, _esn0(esn0_db, esn0_linear))


class Transmitter:
    """The channel interface: transmit(signal, generator)."""

    def transmit(self, signal: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError


class Awgn(Transmitter):
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


class Rayleigh(Transmitter):
    def __init__(self, esn0_db: float = 5.0):
        self.esn0_db = float(esn0_db)
        self.esn0_linear = 10.0 ** (self.esn0_db / 10.0)

    def set_esn0_linear(self, esn0_linear: float):
        self.esn0_linear = float(esn0_linear)

    def transmit(self, signal: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return apply_rayleigh(signal, generator, esn0_linear=self.esn0_linear)


class Scale(Transmitter):
    """Constant amplification (headroom for int8 quantisation)."""

    def __init__(self, factor: float = 1.0):
        self.factor = float(factor)

    def set_factor(self, factor: float):
        self.factor = float(factor)

    def transmit(self, signal: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return signal * self.factor
