"""Density-evolution (Tal-Vardy) construction + aff3ct table import.

A copy of polar_codes_tpu/construction/densityevolution.py, float64
NumPy/scipy in the same operation order. Both of its paths are here:

* `tal_vardy_frozen_bits` — a native implementation of Tal & Vardy,
  "How to Construct Polar Codes" (IEEE T-IT 2013): the BPSK-AWGN channel
  is quantized to a discrete symmetric channel, each polarization step
  applies the exact check (W-) / variable (W+) channel transforms, and the
  output alphabet is degraded back to <= mu symbols. The degrading merge
  is the paper's greedy minimum-capacity-loss merge of LR-adjacent
  symbols, preceded by a lossless equal-LR merge and a vectorized
  pairwise-halving pre-reduction down to 4*mu (pure-Python exact merging
  of ~2*mu^2 symbols per transform would dominate construction time; the
  pre-reduction keeps the exact greedy stage at <= 3*mu merges).
  Frozen set = the N-K synthesized channels with the largest
  error probability Pe(W_i) = sum_y min(W_i(y|0), W_i(y|1)) / 2.

* `aff3ct_frozen_bits` — reads aff3ct's TV config file format (line 0:
  block length, line 1: 'awgn', line 2: sigma, line 3: reliability-ordered
  positions, best first) and picks the file whose sigma is closest to
  10^(-dSNR/10), exactly as FrozenBitPositionsDE._load_files does
  (frozen_bit_positions.py:147-165); frozen = positions[K:].

Host-side NumPy: construction runs once and is baked into traced programs.
"""

from __future__ import annotations

import heapq
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
from scipy.special import ndtr

_CACHE: dict = {}


# -- symbol-vector helpers ---------------------------------------------------
# A channel is a pair of float64 arrays (p0, p1): p0[y] = W(y|0),
# p1[y] = W(y|1), symbols sorted by LLR = log(p0/p1) ascending.


def _capacity_terms(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Per-symbol contribution to I(W) in bits (Tal-Vardy eq. for C(a,b))."""
    s = p0 + p1
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = np.where(p0 > 0, p0 * np.log2(np.where(p0 > 0, 2 * p0 / s, 1.0)), 0.0)
        t1 = np.where(p1 > 0, p1 * np.log2(np.where(p1 > 0, 2 * p1 / s, 1.0)), 0.0)
    return t0 + t1


def _sort_by_llr(p0: np.ndarray, p1: np.ndarray):
    with np.errstate(divide="ignore"):
        llr = np.log(np.maximum(p0, 1e-300)) - np.log(np.maximum(p1, 1e-300))
    order = np.argsort(llr, kind="stable")
    return p0[order], p1[order]


def _merge_equal_llr(p0: np.ndarray, p1: np.ndarray):
    """Lossless merge of symbols with (numerically) identical LR."""
    with np.errstate(divide="ignore"):
        key = np.round(
            np.log(np.maximum(p0, 1e-300)) - np.log(np.maximum(p1, 1e-300)), 9
        )
    _, inv = np.unique(key, return_inverse=True)
    n = inv.max() + 1
    q0 = np.bincount(inv, weights=p0, minlength=n)
    q1 = np.bincount(inv, weights=p1, minlength=n)
    return _sort_by_llr(q0, q1)


def _halve(p0: np.ndarray, p1: np.ndarray):
    """Merge LLR-adjacent pairs (vectorized coarse degrade)."""
    m = p0.size // 2 * 2
    q0 = p0[:m:2] + p0[1:m:2]
    q1 = p1[:m:2] + p1[1:m:2]
    if p0.size % 2:
        q0 = np.append(q0, p0[-1])
        q1 = np.append(q1, p1[-1])
    return q0, q1


def _greedy_degrade(p0: np.ndarray, p1: np.ndarray, mu: int):
    """Exact Tal-Vardy degrading merge: repeatedly merge the LR-adjacent
    symbol pair with the smallest capacity loss until <= mu symbols."""
    m = p0.size
    if m <= mu:
        return p0, p1
    a = p0.copy()
    b = p1.copy()
    cap = _capacity_terms(a, b)
    nxt = list(range(1, m)) + [-1]
    prv = [-1] + list(range(m - 1))
    alive = np.ones(m, dtype=bool)

    def loss(i, j):
        return cap[i] + cap[j] - _capacity_terms(a[i] + a[j], b[i] + b[j])

    heap = [(loss(i, i + 1), i, i + 1) for i in range(m - 1)]
    heapq.heapify(heap)
    remaining = m
    while remaining > mu and heap:
        dl, i, j = heapq.heappop(heap)
        if not (alive[i] and alive[j]) or nxt[i] != j:
            continue  # stale entry
        a[i] += a[j]
        b[i] += b[j]
        cap[i] = _capacity_terms(a[i], b[i])
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[j] != -1:
            prv[nxt[j]] = i
        remaining -= 1
        if nxt[i] != -1:
            heapq.heappush(heap, (loss(i, nxt[i]), i, nxt[i]))
        if prv[i] != -1:
            heapq.heappush(heap, (loss(prv[i], i), prv[i], i))
    return _sort_by_llr(a[alive], b[alive])


def _degrade(p0: np.ndarray, p1: np.ndarray, mu: int):
    p0, p1 = _merge_equal_llr(p0, p1)
    while p0.size > 4 * mu:
        p0, p1 = _halve(p0, p1)
    return _greedy_degrade(p0, p1, mu)


# -- channel transforms -------------------------------------------------------


def _transform_minus(p0: np.ndarray, p1: np.ndarray):
    """W-(y1,y2|u1) = 1/2 sum_u2 W(y1|u1+u2)W(y2|u2)."""
    q0 = 0.5 * (np.outer(p0, p0) + np.outer(p1, p1)).ravel()
    q1 = 0.5 * (np.outer(p0, p1) + np.outer(p1, p0)).ravel()
    return q0, q1


def _transform_plus(p0: np.ndarray, p1: np.ndarray):
    """W+(y1,y2,u1|u2) = 1/2 W(y1|u1+u2) W(y2|u2)."""
    q0 = 0.5 * np.concatenate(
        [np.outer(p0, p0).ravel(), np.outer(p1, p0).ravel()]
    )
    q1 = 0.5 * np.concatenate(
        [np.outer(p1, p1).ravel(), np.outer(p0, p1).ravel()]
    )
    return q0, q1


def _awgn_channel(sigma2: float, mu: int):
    """Quantized BPSK-AWGN: y ~ N(+-1, sigma2), fine grid then degrade."""
    sigma = float(np.sqrt(sigma2))
    lim = 1.0 + 8.0 * sigma
    edges = np.linspace(-lim, lim, 16 * mu + 1)
    edges[0], edges[-1] = -np.inf, np.inf
    # bit 0 -> +1, bit 1 -> -1 (bipolar convention, dsp/modem.py)
    p0 = np.diff(ndtr((edges - 1.0) / sigma))
    p1 = np.diff(ndtr((edges + 1.0) / sigma))
    p0, p1 = _sort_by_llr(p0, p1)
    return _degrade(p0, p1, mu)


def _error_prob(p0: np.ndarray, p1: np.ndarray) -> float:
    """Pe under ML decision; ties counted half (symmetric channel)."""
    return float(0.5 * np.sum(np.minimum(p0, p1)))


# -- public API ---------------------------------------------------------------


def tal_vardy_error_probabilities(
    block_length: int, design_snr_db: float = 0.0, mu: int = 128
) -> np.ndarray:
    """Pe of every synthesized channel via quantized density evolution.

    Index convention matches the GA recursion (gaussian.py:91-94): at each
    polarization level the check (W-) child takes the even index, the
    variable (W+) child the odd index, with the newest level as the least
    significant bit.
    """
    n = block_length.bit_length() - 1
    if (1 << n) != block_length:
        raise ValueError(f"block length {block_length} is not a power of 2")
    key = (block_length, round(float(design_snr_db), 6), mu)
    if key in _CACHE:
        return _CACHE[key]
    # initial mean LLR 2*10^(snr/10) as in GA  =>  sigma^2 = 10^(-snr/10)
    sigma2 = 10.0 ** (-design_snr_db / 10.0)
    channels: List[Tuple[np.ndarray, np.ndarray]] = [_awgn_channel(sigma2, mu)]
    for _ in range(n):
        nxt: List[Tuple[np.ndarray, np.ndarray]] = []
        for p0, p1 in channels:
            nxt.append(_degrade(*_transform_minus(p0, p1), mu))
            nxt.append(_degrade(*_transform_plus(p0, p1), mu))
        channels = nxt
    pe = np.array([_error_prob(p0, p1) for p0, p1 in channels])
    _CACHE[key] = pe
    return pe


def tal_vardy_frozen_bits(
    block_length: int,
    info_length: int,
    design_snr_db: float = 0.0,
    mu: int = 128,
) -> np.ndarray:
    """Frozen positions: the N-K channels with the largest Pe, sorted."""
    pe = tal_vardy_error_probabilities(block_length, design_snr_db, mu)
    order = np.argsort(-pe, kind="stable")
    return np.sort(order[: block_length - info_length]).astype(np.int64)


def _parse_aff3ct_file(path: Path) -> dict:
    """aff3ct TV config format (frozen_bit_positions.py:128-145)."""
    result = {}
    with open(path) as f:
        for i, line in enumerate(f):
            text = line.strip("\n")
            if i == 0:
                result["block_length"] = int(text)
            elif i == 1:
                result["channel"] = str(text)
            elif i == 2:
                result["sigma"] = float(text)
            elif i == 3:
                result["positions"] = np.array([int(p) for p in text.split()])
            else:
                raise ValueError("Unexpected file format!")
    return result


def aff3ct_frozen_bits(
    block_length: int,
    info_length: int,
    design_snr_db: float = 0.0,
    path: Optional[str] = None,
) -> np.ndarray:
    """Import an aff3ct Tal-Vardy table; frozen = positions[K:] of the file
    whose sigma is closest to 10^(-dSNR/10) (FrozenBitPositionsDE parity).

    `path` (or $AFF3CT_TV_PATH) points at the directory that contains one
    subdirectory per log2(N) with the awgn TV files.
    """
    base = Path(path or os.environ.get("AFF3CT_TV_PATH", ""))
    subdir = base / str(block_length.bit_length() - 1)
    if not subdir.is_dir():
        raise FileNotFoundError(
            f"no aff3ct TV tables under '{subdir}'; set AFF3CT_TV_PATH or "
            "use the native tal_vardy_frozen_bits"
        )
    target_sigma = 10.0 ** (-design_snr_db / 10.0)
    best, best_err = None, np.inf
    for f in sorted(subdir.iterdir()):
        info = _parse_aff3ct_file(f)
        if info.get("block_length") != block_length:
            continue
        if info.get("channel") != "awgn":
            continue
        err = abs(info["sigma"] - target_sigma)
        if err < best_err:
            best, best_err = info, err
    if best is None:
        raise FileNotFoundError(f"no matching awgn table for N={block_length}")
    return np.sort(best["positions"][info_length:]).astype(np.int64)


def density_evolution_frozen_bits(
    block_length: int,
    info_length: int,
    design_snr_db: float = 0.0,
    mu: int = 128,
    path: Optional[str] = None,
) -> np.ndarray:
    """'DE' strategy entry: aff3ct tables when available, else native TV."""
    if path or os.environ.get("AFF3CT_TV_PATH"):
        try:
            return aff3ct_frozen_bits(
                block_length, info_length, design_snr_db, path
            )
        except FileNotFoundError:
            pass
    return tal_vardy_frozen_bits(block_length, info_length, design_snr_db, mu)
