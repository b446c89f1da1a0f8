"""GF(2) code-structure helpers, a NumPy copy of
polar_codes_tpu/tools/code_tools.py.

The codecs never build these matrices (the butterfly is O(N log N)); the
generator and systematic matrices are the ground truth that tests and
analyses check the codecs against."""

from __future__ import annotations

import numpy as np


def polar_generator_matrix(n: int) -> np.ndarray:
    """F^{(x) log2 n} in natural (non-bit-reversed) order."""
    f = np.array([[1, 0], [1, 1]], dtype=np.uint8)
    g = np.array([[1]], dtype=np.uint8)
    while g.shape[0] < n:
        g = np.kron(g, f)
    return g


def info_indices_from_frozen(frozen_indices, n: int) -> np.ndarray:
    return np.setdiff1d(np.arange(n, dtype=np.int64),
                        np.asarray(frozen_indices, dtype=np.int64))


def frozen_indices_to_map(frozen_indices, n: int) -> np.ndarray:
    """{0,1} mask with 1 at frozen positions (polar_code_tools.py:89)."""
    m = np.zeros(n, dtype=np.uint8)
    m[np.asarray(frozen_indices, dtype=np.int64)] = 1
    return m


def systematic_encoder_matrix(n: int, frozen_indices) -> np.ndarray:
    """G_sys [K, N] such that u_info @ G_sys places u_info verbatim at the
    information positions (Vangala EncoderA;
    polar_code_tools.py:119-139 get_polar_encoder_matrix_systematic)."""
    g = polar_generator_matrix(n)
    info = info_indices_from_frozen(frozen_indices, n)
    # x = ((u E) G restricted) — systematic transform is G_AI^-1 G_A*;
    # computed directly via the double-transform trick:
    k = len(info)
    basis = np.zeros((k, n), dtype=np.uint8)
    basis[np.arange(k), info] = 1
    x = (basis @ g) % 2  # first transform
    x[:, np.asarray(frozen_indices, dtype=np.int64)] = 0  # re-freeze
    return (x @ g) % 2  # second transform


def bit_reverse(value: int, bitwidth: int) -> int:
    """Reverse the low `bitwidth` bits (polar_code_tools.py:95-102)."""
    out = 0
    for _ in range(bitwidth):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def bit_reversed_vector(bitwidth: int) -> np.ndarray:
    return np.array(
        [bit_reverse(i, bitwidth) for i in range(1 << bitwidth)],
        dtype=np.int64,
    )
