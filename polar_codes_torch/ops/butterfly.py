"""Polar butterfly transform (x = u F^{(x)n}, natural order, no bit reversal).

Plain tensor code, as in polar_codes_tpu/ops/butterfly.py: each stage is a
reshape + XOR (or multiply, in bipolar form) over the whole batch. The
transform is an involution. `polar_transform_mxu` (the matmul form for
N > 2048) is not ported yet.
"""

from __future__ import annotations

import torch


def _check_length(n_len: int) -> None:
    if n_len < 1 or n_len & (n_len - 1):
        raise ValueError(f"block length {n_len} is not a power of 2")


def butterfly_transform(bits: torch.Tensor) -> torch.Tensor:
    """In-order polar transform on {0,1} integer bits, last axis N = 2^n.

    Stage s: x[i] ^= x[i + 2^s] for every i whose s-th bit is 0."""
    n_len = bits.shape[-1]
    _check_length(n_len)
    lead = bits.shape[:-1]
    x = bits
    half = 1
    while half < n_len:
        x = x.reshape(lead + (n_len // (2 * half), 2, half))
        x = torch.stack([x[..., 0, :] ^ x[..., 1, :], x[..., 1, :]], dim=-2)
        half *= 2
    return x.reshape(lead + (n_len,))


def butterfly_transform_bipolar(signs: torch.Tensor) -> torch.Tensor:
    """The same transform on {+1,-1} floats: XOR becomes multiply."""
    n_len = signs.shape[-1]
    _check_length(n_len)
    lead = signs.shape[:-1]
    x = signs
    half = 1
    while half < n_len:
        x = x.reshape(lead + (n_len // (2 * half), 2, half))
        x = torch.stack([x[..., 0, :] * x[..., 1, :], x[..., 1, :]], dim=-2)
        half *= 2
    return x.reshape(lead + (n_len,))
