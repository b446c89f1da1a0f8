"""Polar encoder: batched systematic / non-systematic butterfly encoding.

The port of polar_codes_tpu/models/encoder.py PolarEncoder: the CRC is
written into the info tail, the info bits are scattered to the non-frozen
positions, and the butterfly encoder (kernel K2 on the card,
ops/butterfly_kernel.py) runs the transform -> re-freeze -> transform
sequence of systematic encoding. The kernel covers N <= 2048; above that
the encoder takes the JAX package's matmul route (`_encode_mxu`): the
transform as two dense GF(2) products (ops/butterfly.py
polar_transform_mxu), the re-freeze as a product with the inverse mask,
and the transform again in systematic mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..construction import frozen_bit_mask, info_indices
from ..ops.butterfly import butterfly_transform, polar_transform_mxu
from ..ops.butterfly_kernel import MAX_N, butterfly_encode
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .detectors import Detector, Dummy


class PolarEncoder:
    """Batched polar encoder for one (N, frozen set) code. The code's
    constants live on `device` (the card unless the caller asks for the
    CPU); inputs must be there too."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        device=DEFAULT_DEVICE,
    ):
        n = block_length.bit_length() - 1
        if (1 << n) != block_length:
            raise ValueError(f"block length {block_length} is not a power of 2")
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.frozen_mask = frozen_bit_mask(block_length, self.frozen)
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.device = resolve_device(device)
        self._info_pos_t = torch.as_tensor(self.info_pos, device=self.device)
        self._mask_t = torch.as_tensor(self.frozen_mask.astype(np.uint8),
                                       device=self.device)
        self._inv_mask_t = 1.0 - self._mask_t.to(torch.float32)

    def _check(self, bits: torch.Tensor, length: int) -> None:
        if bits.shape[-1] != length:
            raise ValueError(f"expected {length} bits, got {bits.shape[-1]}")
        if bits.device != self.device:
            raise ValueError(f"encoder lives on {self.device}, bits on {bits.device}")

    def inject(self, info_bits: torch.Tensor) -> torch.Tensor:
        """Scatter [..., K] info bits into a [..., N] u-vector (frozen = 0)."""
        self._check(info_bits, self.info_length)
        u = torch.zeros(info_bits.shape[:-1] + (self.block_length,),
                        dtype=info_bits.dtype, device=info_bits.device)
        u[..., self._info_pos_t] = info_bits
        return u

    def extract(self, block_bits: torch.Tensor) -> torch.Tensor:
        """Gather [..., N] -> [..., K] info bits at the non-frozen positions."""
        self._check(block_bits, self.block_length)
        return block_bits.index_select(-1, self._info_pos_t)

    def encode(self, info_bits: torch.Tensor, generate_crc: bool = True) -> torch.Tensor:
        """[..., K] info bits -> [..., N] uint8 codeword bits. With a CRC
        detector and generate_crc, the last tail_bits of the info block are
        overwritten with the checksum first."""
        self._check(info_bits, self.info_length)
        x = info_bits.to(torch.uint8)
        if generate_crc and self.detector.tail_bits:
            x = self.detector.generate(x)
        lead = x.shape[:-1]
        u = self.inject(x).reshape(-1, self.block_length).contiguous()
        if self.block_length > MAX_N:
            return self._encode_mxu(u).reshape(lead + (self.block_length,))
        code = butterfly_encode(u, self._mask_t, self.systematic)
        return code.reshape(lead + (self.block_length,))

    def transform(self, bits: torch.Tensor) -> torch.Tensor:
        """The raw N-stage butterfly (an involution), for decoders that
        re-encode a codeword estimate to recover u."""
        return butterfly_transform(bits)

    def _encode_mxu(self, u01: torch.Tensor) -> torch.Tensor:
        """[B, N] u-domain bits -> [B, N] uint8 codeword by the product form
        of the transform (both passes in systematic mode)."""
        code = polar_transform_mxu(u01)
        if self.systematic:
            code = polar_transform_mxu(code * self._inv_mask_t)  # re-freeze
        return code.to(torch.uint8)
