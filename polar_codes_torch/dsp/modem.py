"""Modems: BPSK and power-normalized multi-level ASK, as in
polar_codes_tpu/dsp/modem.py.

Bit 0 -> +1, bit 1 -> -1; the demodulators are soft-output (BPSK's is the
identity). The ASK arithmetic keeps the JAX package's operation order, so
both give the same float32 values.
"""

from __future__ import annotations

import torch

from ..utils.bits import bipolar_from_bits


def bpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} bits -> {+1,-1} float32 symbols."""
    return bipolar_from_bits(bits)


def bpsk_demodulate(symbols: torch.Tensor) -> torch.Tensor:
    """The received sample is the bit metric."""
    return symbols.to(torch.float32)


def _ask_normal_magnitude(bits_per_symbol: int) -> float:
    """sqrt(mean symbol power) over the 2^b-ASK alphabet {±1, ±3, ...}."""
    levels = 1 << bits_per_symbol
    power = sum(float(s) ** 2 for s in range(1, levels, 2))
    return (2.0 * power / levels) ** 0.5


def ask_modulate(bits: torch.Tensor, bits_per_symbol: int,
                 normalize: bool = True) -> torch.Tensor:
    """{0,1} bits [..., n*b] -> [..., n] ASK symbols, E[x^2] = 1 if
    normalized. Per symbol, for bit j (MSB first): memory *= bipolar_j;
    symbol = sum_j memory_j * 2^(b-1-j). A bit count that is not a whole
    number of symbols is padded with bit 0 (+1.0), and the demodulator
    returns the pad bits' metrics too (the reference's semantics)."""
    x = bpsk_modulate(bits)
    n_bits = x.shape[-1]
    if n_bits % bits_per_symbol:
        pad = bits_per_symbol - n_bits % bits_per_symbol
        x = torch.cat([x, torch.ones(x.shape[:-1] + (pad,), dtype=x.dtype,
                                     device=x.device)], dim=-1)
        n_bits += pad
    grouped = x.reshape(x.shape[:-1] + (n_bits // bits_per_symbol, bits_per_symbol))
    memory = torch.cumprod(grouped, dim=-1)
    weights = 2.0 ** torch.arange(bits_per_symbol - 1, -1, -1, dtype=torch.float32,
                                  device=x.device)
    symbols = torch.sum(memory * weights, dim=-1)
    if normalize:
        symbols = symbols / _ask_normal_magnitude(bits_per_symbol)
    return symbols


def ask_demodulate(symbols: torch.Tensor, bits_per_symbol: int,
                   normalize: bool = True) -> torch.Tensor:
    """[..., n] symbols -> [..., n*b] soft bit metrics by successive
    approximation: emit the amplitude, then amplitude = |amplitude| - shift
    with the shift halving."""
    y = symbols.to(torch.float32)
    if normalize:
        y = y * _ask_normal_magnitude(bits_per_symbol)
    outs = []
    amplitude = y
    shift = float(1 << (bits_per_symbol - 1))
    for _ in range(bits_per_symbol):
        outs.append(amplitude)
        amplitude = torch.abs(amplitude) - shift
        shift /= 2.0
    soft = torch.stack(outs, dim=-1)
    return soft.reshape(y.shape[:-1] + (y.shape[-1] * bits_per_symbol,))


class Modem:
    """The modem interface: modulate and demodulate."""

    bits_per_symbol = 1

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def demodulate(self, symbols: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Bpsk(Modem):
    bits_per_symbol = 1

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        return bpsk_modulate(bits)

    def demodulate(self, symbols: torch.Tensor) -> torch.Tensor:
        return bpsk_demodulate(symbols)


class Ask(Modem):
    def __init__(self, bits_per_symbol: int = 1, normalize: bool = True):
        self.bits_per_symbol = bits_per_symbol
        self.normalize = normalize

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        return ask_modulate(bits, self.bits_per_symbol, self.normalize)

    def demodulate(self, symbols: torch.Tensor) -> torch.Tensor:
        return ask_demodulate(symbols, self.bits_per_symbol, self.normalize)
