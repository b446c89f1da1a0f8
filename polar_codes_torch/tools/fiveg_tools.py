"""5G NR polar rate matching (TS 38.212 section 5.4.1), a NumPy copy of
polar_codes_tpu/tools/fiveg_tools.py: the sub-block interleaver over 32
blocks (pattern Table 5.4.1.1-1) plus the circular-buffer bit selection
(puncturing E < N from the front, shortening from the back, repetition
E > N), and its receiver-side inverse on LLRs. models/puncturer.py is its
shortening-style sibling for codes of any length.
"""

from __future__ import annotations

import numpy as np

# TS 38.212 Table 5.4.1.1-1 sub-block interleaver pattern P(i)
SUBBLOCK_INTERLEAVER_PATTERN = np.array(
    [0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19, 12, 20, 13, 21,
     14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31],
    dtype=np.int64,
)


def nr_subblock_permutation(n: int) -> np.ndarray:
    """J(n): output n comes from input J(n) (TS 38.212 5.4.1.1)."""
    if n % 32:
        raise ValueError("block length must be a multiple of 32")
    out = np.empty(n, dtype=np.int64)
    b = n // 32
    for j in range(n):
        i = (32 * j) // n
        out[j] = SUBBLOCK_INTERLEAVER_PATTERN[i] * b + (j % b)
    return out


def nr_subblock_interleave(sequence: np.ndarray) -> np.ndarray:
    """y[n] = d[J(n)] (polar5g_rate_match semantics)."""
    seq = np.asarray(sequence)
    return seq[..., nr_subblock_permutation(seq.shape[-1])]


def nr_rate_match(
    codeword: np.ndarray, e_len: int, mode: str = "puncture"
) -> np.ndarray:
    """[..., N] encoded bits -> [..., E] transmitted bits.

    E < N with mode="puncture": skip the first N-E bits of the circular
    buffer (5.4.1.2, low-rate case); mode="shorten": drop the last N-E
    (high-rate case, those bits are known zero). E > N: repetition."""
    y = nr_subblock_interleave(codeword)
    n = y.shape[-1]
    if e_len <= n:
        if mode == "puncture":
            return y[..., n - e_len :]
        if mode == "shorten":
            return y[..., :e_len]
        raise ValueError(f"unknown rate-match mode {mode}")
    reps = [y] * (e_len // n)
    if e_len % n:
        reps.append(y[..., : e_len % n])
    return np.concatenate(reps, axis=-1)


def nr_rate_recover(
    llrs: np.ndarray, n: int, mode: str = "puncture"
) -> np.ndarray:
    """[..., E] received LLRs -> [..., N] decoder input.

    Punctured positions get neutral LLR 0; shortened positions get a large
    positive LLR (bit known zero); repeated positions soft-combine."""
    llrs = np.asarray(llrs, dtype=np.float64)
    e_len = llrs.shape[-1]
    perm = nr_subblock_permutation(n)
    if e_len <= n:
        if mode == "puncture":
            y = np.zeros(llrs.shape[:-1] + (n,), dtype=np.float64)
            y[..., n - e_len :] = llrs
        elif mode == "shorten":
            y = np.full(llrs.shape[:-1] + (n,), 1e9, dtype=np.float64)
            y[..., :e_len] = llrs
        else:
            raise ValueError(f"unknown rate-match mode {mode}")
    else:
        y = np.zeros(llrs.shape[:-1] + (n,), dtype=np.float64)
        for start in range(0, e_len, n):
            width = min(n, e_len - start)
            y[..., :width] += llrs[..., start : start + width]
    out = np.zeros_like(y)
    out[..., perm] = y
    return out
