"""5G NR ("5G") construction from the TS 38.212 reliability sequence.

A copy of polar_codes_tpu/construction/fiveg.py. For N < 1024 the
standard-conformant behavior keeps only sequence entries < N before taking
the first N-K as frozen (the filtered form, which never emits a frozen
position >= N).
"""

from __future__ import annotations

import numpy as np

from .nr_sequence import NR_RELIABILITY_SEQUENCE_1024

NR_MAX_BLOCK_LENGTH = 1024


def nr_reliability_sequence(block_length: int = 1024) -> np.ndarray:
    """TS 38.212 polar sequence restricted to indices < block_length.

    Ordered from least to most reliable, a permutation of range(block_length).
    """
    if block_length > NR_MAX_BLOCK_LENGTH:
        raise ValueError("5G standard does not allow for block size N > 1024!")
    n = block_length.bit_length() - 1
    if (1 << n) != block_length:
        raise ValueError(f"block length {block_length} is not a power of 2")
    seq = NR_RELIABILITY_SEQUENCE_1024
    if block_length == NR_MAX_BLOCK_LENGTH:
        return seq.copy()
    return seq[seq < block_length].copy()


def nr_frozen_bits(
    block_length: int, info_length: int, design_snr_db: float = 0.0
) -> np.ndarray:
    """Frozen positions: first N-K entries of the restricted sequence, sorted.

    design_snr_db is ignored (table-based construction), as in the reference.
    """
    if block_length < info_length:
        raise ValueError(f"invalid polar code ({block_length}, {info_length})")
    seq = nr_reliability_sequence(block_length)
    frozen = np.sort(seq[: block_length - info_length])
    return frozen.astype(np.int64)
