"""Rate-matching puncturer, the port of polar_codes_tpu/models/puncturer.py.

For a target length M the parent code has N = 2^ceil(log2 M); the first
N - M frozen positions are dropped from the codeword and the surviving
`output_positions` are kept in order. `puncture` is a gather and
`depuncture` a scatter into a block filled with `fill_value` (LLR 0, no
information, at the punctured positions), both on the tensor's device;
`puncture_packed` works on packed bytes on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def round_up_power_of_two(value: int) -> int:
    return 1 << max(int(value) - 1, 0).bit_length()


class Puncturer:
    """Shortening-style rate matcher for one (M, frozen set) code."""

    def __init__(self, block_length: int, frozen_bit_positions: Sequence[int]):
        self.block_length = int(block_length)
        self.parent_block_length = round_up_power_of_two(self.block_length)
        frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        n_punct = self.parent_block_length - self.block_length
        if n_punct > frozen.size:
            raise ValueError(
                "Number of required puncturing positions exceeds frozen bit positions!")
        punctured = frozen[:n_punct]
        keep = np.ones(self.parent_block_length, dtype=bool)
        keep[punctured] = False
        self.output_positions = np.nonzero(keep)[0]
        self.punctured_positions = punctured
        self._index: Dict[torch.device, torch.Tensor] = {}

    def _positions(self, device: torch.device) -> torch.Tensor:
        index = self._index.get(device)
        if index is None:
            index = torch.as_tensor(self.output_positions, device=device)
            self._index[device] = index
        return index

    def puncture(self, block: torch.Tensor) -> torch.Tensor:
        """[..., N_parent] -> [..., M]: keep the output positions in order."""
        return block.index_select(-1, self._positions(block.device))

    def depuncture(self, punctured: torch.Tensor, fill_value=0) -> torch.Tensor:
        """[..., M] -> [..., N_parent]: the dropped positions hold fill_value
        (for LLRs, 0 is the neutral value the decoder expects there)."""
        if punctured.shape[-1] != self.block_length:
            raise ValueError(f"expected {self.block_length} values, got {punctured.shape[-1]}")
        out = torch.full(punctured.shape[:-1] + (self.parent_block_length,), fill_value,
                         dtype=punctured.dtype, device=punctured.device)
        out[..., self._positions(punctured.device)] = punctured
        return out

    def puncture_packed(self, packed_bytes: np.ndarray) -> np.ndarray:
        """Packed bytes, MSB first: [..., N_parent/8] uint8 -> [..., M/8]."""
        if self.parent_block_length % 8 or self.block_length % 8:
            raise ValueError("packed puncturing requires byte-aligned lengths")
        bits = np.unpackbits(np.asarray(packed_bytes, dtype=np.uint8), axis=-1)
        return np.packbits(bits[..., self.output_positions], axis=-1)
