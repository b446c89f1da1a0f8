"""Bit conventions of the port, as in polar_codes_tpu/utils/bits.py.

- "bits":    {0,1} integer tensors, last axis = bit position, MSB-first
             when packed (np.packbits' "big" order, the reference's packed
             byte layout that pypolar reads and writes).
- "bipolar": float tensors in {+1,-1}; bit b <-> 1-2b.
- "llr":     float log-likelihood ratios, positive <-> bit 0.

Hard decisions read the sign bit, so -0.0 decides bit 1 (`x < 0` would
decide bit 0 there). The tensor helpers keep their input's device.
"""

from __future__ import annotations

import numpy as np
import torch

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack {0,1} bits into uint8 bytes, MSB first (np.packbits). The
    length along `axis` must be a multiple of 8."""
    x = bits if axis == -1 else bits.movedim(axis, -1)
    n = x.shape[-1]
    if n % 8:
        raise ValueError(f"bit count {n} not a multiple of 8")
    weights = torch.tensor(_WEIGHTS, dtype=torch.int32, device=x.device)
    x = x.reshape(x.shape[:-1] + (n // 8, 8)).to(torch.int32)
    out = (x * weights).sum(-1).to(torch.uint8)
    return out if axis == -1 else out.movedim(-1, axis)


def unpackbits(data: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Unpack uint8 bytes into {0,1} uint8 bits, MSB first."""
    x = data.to(torch.uint8)
    if axis != -1:
        x = x.movedim(axis, -1)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
    out = ((x[..., None] >> shifts) & 1).reshape(x.shape[:-1] + (x.shape[-1] * 8,))
    return out if axis == -1 else out.movedim(-1, axis)


def bipolar_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} -> {+1,-1} float32."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def bits_from_bipolar(bipolar: torch.Tensor) -> torch.Tensor:
    """{+1,-1} (or any signed value; the sign decides) -> {0,1} uint8, a
    negative sign (-0.0 included) meaning bit 1."""
    return torch.signbit(bipolar).to(torch.uint8)


def hard_decisions(llr: torch.Tensor) -> torch.Tensor:
    """LLRs -> hard bits uint8: the sign bit set (llr < 0, and -0.0) is 1."""
    return torch.signbit(llr).to(torch.uint8)


def polar_generator_matrix(n: int) -> np.ndarray:
    """F^(x)n with F = [[1, 0], [1, 1]], no bit reversal (NumPy, GF(2)): the
    codeword of a natural-order u is u @ G mod 2."""
    f = np.array([[1, 0], [1, 1]], dtype=np.uint8)
    g = np.array([[1]], dtype=np.uint8)
    for _ in range(n):
        g = np.kron(g, f)
    return g
