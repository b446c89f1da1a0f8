"""Polar butterfly transform (x = u F^{(x)n}, natural order, no bit reversal).

Plain tensor code, as in polar_codes_tpu/ops/butterfly.py: each stage is a
reshape + XOR (or multiply, in bipolar form) over the whole batch. The
transform is an involution. `polar_transform_mxu` is the same transform as
two dense GF(2) products, the encoder's route above N = 2048.
"""

from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _transform_matrix(n_len: int) -> np.ndarray:
    """Host-side M with butterfly_transform(u) == (u @ M) % 2 ({0,1} u8):
    row r is the transform of the r-th unit vector."""
    m = np.eye(n_len, dtype=np.uint8)
    h = 1
    while h < n_len:
        m = m.reshape(n_len, n_len // (2 * h), 2, h)
        m[:, :, 0, :] ^= m[:, :, 1, :]
        m = m.reshape(n_len, n_len)
        h *= 2
    return m


def _mod2(y: torch.Tensor) -> torch.Tensor:
    """Integer-valued float32 -> {0,1} float32 (y - 2*floor(y/2))."""
    return y - 2.0 * torch.floor(y * 0.5)


def default_inner(n_len: int) -> int:
    """Factor split of the product form: inner length near sqrt(N), >= 128."""
    root = 1 << ((n_len.bit_length() - 1 + 1) // 2)
    return max(128, min(root, n_len))


def polar_transform_mxu(x01: torch.Tensor) -> torch.Tensor:
    """In-order polar transform on {0,1} values as two dense GF(2) products.

    With N = No*Ni and index i = o*Ni + j, M_N == kron(M_No, M_Ni), so the
    transform is a product with M_Ni over j, mod 2, then a product with
    M_No over o, mod 2. The operands are float32 and TF32 is switched off
    for the call, so every sum (at most max(Ni, No) <= 512 at N = 131072)
    is an exact integer. x01: [..., N] {0,1}, any real or integer dtype.
    Returns [..., N] float32 {0,1}, equal to butterfly_transform."""
    n_len = x01.shape[-1]
    _check_length(n_len)
    n_inner = default_inner(n_len)
    x = x01.to(torch.float32)
    lead = x.shape[:-1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if n_inner >= n_len:
            m = torch.as_tensor(_transform_matrix(n_len), dtype=torch.float32,
                                device=x.device)
            return _mod2(x @ m)
        n_outer = n_len // n_inner
        mi = torch.as_tensor(_transform_matrix(n_inner), dtype=torch.float32,
                             device=x.device)
        mo = torch.as_tensor(_transform_matrix(n_outer), dtype=torch.float32,
                             device=x.device)
        y = _mod2(x.reshape(lead + (n_outer, n_inner)) @ mi)  # contract j
        y = _mod2(mo.T @ y)  # contract o: [.., p, j'] = sum_o Mo[o, p] y[.., o, j']
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return y.reshape(lead + (n_len,))
