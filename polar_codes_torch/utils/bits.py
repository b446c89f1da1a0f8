"""Bit conventions of the port, as in polar_codes_tpu/utils/bits.py.

- "bits":    {0,1} integer tensors, last axis = bit position.
- "bipolar": float tensors in {+1,-1}; bit b <-> 1-2b.
- "llr":     float log-likelihood ratios, positive <-> bit 0.

Hard decisions read the sign bit, so -0.0 decides bit 1 (`x < 0` would
decide bit 0 there).
"""

from __future__ import annotations

import torch


def bipolar_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} -> {+1,-1} float32."""
    return 1.0 - 2.0 * bits.to(torch.float32)
