"""SC update rules f and g in float32, as in polar_codes_tpu/ops/fg.py.

Hard decisions travel in bipolar form {+1., -1.}, so g's sign application
is a multiply. The saturating char forms are not ported yet.
"""

from __future__ import annotations

import torch

_SIGN = -2147483648  # the float32 sign bit as an int32
_MAG = 0x7FFFFFFF


def f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f(a,b) = sign(a)sign(b) * min(|a|,|b|); 0 where either input is 0."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def f_minsum_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min-sum f on the raw float32 bits: sign-XOR + magnitude-min.

    Equal to f_minsum except at exact zeros, where it keeps the XOR of the
    sign bits (so -0.0 and +0.0 differ) instead of returning 0. SCL uses
    this form."""
    ai = a.contiguous().view(torch.int32)
    bi = b.contiguous().view(torch.int32)
    sign = (ai ^ bi) & _SIGN
    mag = torch.minimum(ai & _MAG, bi & _MAG)
    return (sign | mag).view(torch.float32)


def g_update(a: torch.Tensor, b: torch.Tensor, left_bipolar: torch.Tensor) -> torch.Tensor:
    """g(a,b,u) = b + (1-2u)*a, with the left bits in bipolar form."""
    return b + left_bipolar * a
