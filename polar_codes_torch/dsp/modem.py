"""BPSK modem, as in polar_codes_tpu/dsp/modem.py: bit 0 -> +1, bit 1 -> -1,
and soft demodulation is the identity. ASK is not ported yet."""

from __future__ import annotations

import torch

from ..utils.bits import bipolar_from_bits


def bpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} bits -> {+1,-1} float32 symbols."""
    return bipolar_from_bits(bits)


def bpsk_demodulate(symbols: torch.Tensor) -> torch.Tensor:
    """The received sample is the bit metric."""
    return symbols.to(torch.float32)


class Bpsk:
    bits_per_symbol = 1

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        return bpsk_modulate(bits)

    def demodulate(self, symbols: torch.Tensor) -> torch.Tensor:
        return bpsk_demodulate(symbols)
