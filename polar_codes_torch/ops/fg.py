"""SC update rules f and g, as in polar_codes_tpu/ops/fg.py.

Hard decisions travel in bipolar form {+1., -1.}, so g's sign application
is a multiply. Two families: float32, and the saturating char family
(fip_char semantics) on integer-valued LLRs, with g clipped to
[-127, 127]. The char pair comes as `_i8` (int8 tensors, int16
arithmetic) and `_sat` (integers held in a float tensor), which give the
same values on LLRs in [-127, 127].
"""

from __future__ import annotations

import torch

_SIGN = -2147483648  # the float32 sign bit as an int32
_MAG = 0x7FFFFFFF


def _sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with jnp.sign's rule at zero: sign(+-0) = +-0 (torch.sign
    maps -0.0 to +0.0)."""
    return torch.where(x == 0, x, torch.sign(x))


def f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f(a,b) = sign(a)sign(b) * min(|a|,|b|). Where an input is 0 the
    result is a zero whose sign bit is the XOR of the inputs' sign bits,
    as in the JAX package; on finite inputs this is f_minsum_bits bit for
    bit."""
    return _sign(a) * _sign(b) * torch.minimum(a.abs(), b.abs())


def f_minsum_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min-sum f on the raw float32 bits: sign-XOR + magnitude-min. SCL
    uses this form."""
    ai = a.contiguous().view(torch.int32)
    bi = b.contiguous().view(torch.int32)
    sign = (ai ^ bi) & _SIGN
    mag = torch.minimum(ai & _MAG, bi & _MAG)
    return (sign | mag).view(torch.float32)


def g_update(a: torch.Tensor, b: torch.Tensor, left_bipolar: torch.Tensor) -> torch.Tensor:
    """g(a,b,u) = b + (1-2u)*a, with the left bits in bipolar form."""
    return b + left_bipolar * a


def combine_bipolar(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Combine in bipolar form: left XOR right is left * right."""
    return left * right


def f_minsum_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 min-sum f with an int16 intermediate (fip_char F)."""
    a16, b16 = a.to(torch.int16), b.to(torch.int16)
    sign = torch.sign(a16) * torch.sign(b16)
    return (sign * torch.minimum(a16.abs(), b16.abs())).to(torch.int8)


def g_update_i8(a: torch.Tensor, b: torch.Tensor, left_bipolar: torch.Tensor) -> torch.Tensor:
    """int8 g, saturated to [-127, 127] (fi_adds_epi8)."""
    s = b.to(torch.int16) + left_bipolar.to(torch.int16) * a.to(torch.int16)
    return torch.clamp(s, -127, 127).to(torch.int8)


def f_minsum_sat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Char min-sum f on integers held in a float tensor, computed in
    float32 and returned in a's dtype (value-equal to f_minsum_i8)."""
    return f_minsum(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def g_update_sat(a: torch.Tensor, b: torch.Tensor, left_bipolar: torch.Tensor) -> torch.Tensor:
    """Char g on integers held in a float tensor, clipped to [-127, 127]
    (value-equal to g_update_i8)."""
    s = b.to(torch.float32) + left_bipolar.to(torch.float32) * a.to(torch.float32)
    return torch.clamp(s, -127.0, 127.0).to(a.dtype)


def split_llr(llr: torch.Tensor):
    """Split [..., 2m] node LLRs into their (upper a, lower b) halves [..., m]."""
    m = llr.shape[-1] // 2
    return llr[..., :m], llr[..., m:]


def merge_bits(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The parent span's bipolar decisions from its children's:
    [left * right, right]."""
    return torch.cat([combine_bipolar(left, right), right], dim=-1)
