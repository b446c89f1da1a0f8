"""Error locator: genie-aided SC analysis of first-error positions, the
port of polar_codes_tpu/models/errorlocator.py.

Every past decision is forced to the transmitted truth, so each u-domain
decision LLR depends on the channel and the truth only. The JAX package
computes them by the SC recursion (~2N node calls); here the pass runs
level by level, log2 N steps over the whole batch: at span s the LLRs and
the bipolar truth are viewed as [B, N/s, 2, s/2] halves (a, b) and
(xl, xr), the next level is [f(a, b) | g(a, b, xl * xr)] and its truth
[xl * xr | xr]. Each value goes through the same f and g as in the
recursion, so the result is bit-equal to it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..construction import frozen_bit_mask, info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.fg import f_minsum, g_update
from ..utils.device import DEFAULT_DEVICE, resolve_device


def genie_llrs(llr: torch.Tensor, x_bipolar: torch.Tensor) -> torch.Tensor:
    """Decision LLR of every u bit with all previous bits forced true:
    llr [B, N] channel LLRs, x_bipolar [B, N] the true codeword in {+1, -1}
    -> [B, N] u-domain decision LLRs."""
    n_batch, n_len = llr.shape
    span = n_len
    while span > 1:
        half = span // 2
        a, b = llr.reshape(n_batch, n_len // span, 2, half).unbind(2)
        xl, xr = x_bipolar.reshape(n_batch, n_len // span, 2, half).unbind(2)
        left_truth = xl * xr
        llr = torch.stack([f_minsum(a, b), g_update(a, b, left_truth)], 2)
        x_bipolar = torch.stack([left_truth, xr], 2)
        span = half
    return llr.reshape(n_batch, n_len)


class ErrorLocator:
    """Genie-aided SC first-error analyser for one (N, frozen set) code.
    Its constants live on `device` (the card unless the caller asks for the
    CPU); inputs must be there too."""

    def __init__(self, block_length: int, frozen_bit_positions: Sequence[int],
                 device=DEFAULT_DEVICE):
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.frozen_mask = frozen_bit_mask(block_length, self.frozen)
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.device = resolve_device(device)
        self._info_mask_t = torch.as_tensor(~self.frozen_mask, device=self.device)

    def locate(self, llr: torch.Tensor,
               true_codeword: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., N] LLRs and the true codeword bits {0, 1} -> (first_error
        [...] int64, error_mask [..., N] bool).

        error_mask[i]: the genie-aided SC decision at u-channel i, llr < 0
        deciding 1, would be wrong (frozen channels never err). first_error
        is the lowest such i, or N for a frame without an error."""
        if llr.shape[-1] != self.block_length or true_codeword.shape != llr.shape:
            raise ValueError(
                f"expected LLRs and codeword bits of length {self.block_length} and one "
                f"shape, got {tuple(llr.shape)} and {tuple(true_codeword.shape)}")
        if llr.device != self.device or true_codeword.device != self.device:
            raise ValueError(f"locator lives on {self.device}, inputs on {llr.device}")
        n_len = self.block_length
        lead = llr.shape[:-1]
        code = true_codeword.to(torch.uint8).reshape(-1, n_len)
        x = 1.0 - 2.0 * code.to(torch.float32)
        u_llr = genie_llrs(llr.to(torch.float32).reshape(-1, n_len), x)
        u_true = butterfly_transform(code)  # an involution: codeword -> u
        err = ((u_llr < 0).to(torch.uint8) != u_true) & self._info_mask_t
        idx = torch.arange(n_len, device=self.device)
        first = torch.where(err, idx, n_len).min(dim=-1).values
        return first.reshape(lead), err.reshape(lead + (n_len,))
