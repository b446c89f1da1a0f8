"""Adaptive decoder: Fast-SSC first, CA-SCL on the blocks whose CRC fails.

The port of polar_codes_tpu/models/adaptive.py AdaptiveDecoder (the
reference's AdaptiveFloat / AdaptiveMixed; "mixed" is an int8 fast pass
with a float32 list pass, the simulator's default precision 832). The
fast pass (kernel K3) runs on the whole batch; the rows whose CRC fails
are found on the host and re-decoded by the next list stage (kernel K1),
whose results are written back. The JAX package pads the failed rows to a
power-of-2 bucket to bound XLA's compile cache; PyTorch compiles nothing
per shape, so the port decodes exactly the failed rows, with the same
results, since every row decodes on its own.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from .detectors import CRC32, Detector
from .fastssc import FastSSCDecoder
from .scl import SCLDecoder


class AdaptiveDecoder:
    """Fast-SSC + CA-SCL fallback for one (N, frozen set) code.

    list_schedule escalates stage by stage: the CRC failures of stage i
    are re-decoded at stage i + 1, e.g. (2, 8) or (3, 12): any list
    sizes; the default is (list_size,). fast_dtype (float32, int8 or
    bfloat16) is the Fast-SSC pass's family; the list stages run float32. fast_subtree_fn and list_subtree_fn pass a subtree
    function to the Fast-SSC pass and to every list stage (the plain
    versions, to run them on the card)."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        list_size: int = 8,
        systematic: bool = True,
        detector: Optional[Detector] = None,
        fast_dtype: torch.dtype = torch.float32,
        list_schedule: Optional[Sequence[int]] = None,
        device=DEFAULT_DEVICE,
        fast_subtree_fn=None,
        list_subtree_fn=None,
    ):
        # the reference attaches CRC32 by default (decoder.cpp makeDecoder)
        self.detector = detector if detector is not None else CRC32()
        if not self.detector.tail_bits:
            raise ValueError("AdaptiveDecoder requires a detector with tail bits (a CRC)")
        self.device = resolve_device(device)
        self.block_length = block_length
        self.list_size = int(list_size)
        self.systematic = systematic
        self.dtype = fast_dtype
        self.fast = FastSSCDecoder(
            block_length, frozen_bit_positions, systematic=systematic,
            detector=self.detector, dtype=fast_dtype, device=self.device,
            subtree_fn=fast_subtree_fn)
        if list_schedule is None:
            list_schedule = (self.list_size,) if self.list_size > 1 else ()
        self.list_schedule = tuple(int(l) for l in list_schedule)
        self.stages = [
            SCLDecoder(block_length, frozen_bit_positions, list_size=l,
                       systematic=systematic, detector=self.detector,
                       device=self.device, subtree_fn=list_subtree_fn)
            for l in self.list_schedule
        ]
        self.list = self.stages[-1] if self.stages else None
        self.frozen = self.fast.frozen
        self.info_pos = self.fast.info_pos
        self.info_length = self.fast.info_length
        self.tree = self.fast.tree
        self.rerun_rows = []  # rows re-decoded at each stage by the last decode()

    def _fast_input(self, flat: torch.Tensor) -> torch.Tensor:
        return flat if self.dtype == torch.int8 else flat.to(self.dtype)

    def decode(self, llr: torch.Tensor):
        """[B, N] (or [N]) LLRs -> (info [.., K], codeword [.., N], ok [..]).

        Host-orchestrated: the fast pass's CRC flags, read on the host,
        select the rows each list stage re-decodes."""
        flat = llr.reshape(-1, self.block_length)
        info, codeword, ok = self.fast.decode(self._fast_input(flat))
        self.rerun_rows = []
        for stage in self.stages:
            failed = torch.nonzero(~ok).flatten()
            self.rerun_rows.append(int(failed.numel()))
            if not failed.numel():
                break
            s_info, s_code, s_ok = stage.decode(flat.index_select(0, failed).to(torch.float32))
            info[failed] = s_info
            codeword[failed] = s_code
            ok[failed] = s_ok
        lead = llr.shape[:-1]
        info = info.reshape(lead + (self.info_length,))
        codeword = codeword.reshape(lead + (self.block_length,))
        return info, codeword, ok.reshape(lead)

    def decode_fused(self, llr: torch.Tensor):
        """No host sync: both decoders run on the whole batch, and each row
        takes the fast result where its CRC holds, else the list result."""
        f_info, f_code, f_ok = self.fast.decode(self._fast_input(llr))
        if self.list is None:
            return f_info, f_code, f_ok
        l_info, l_code, l_ok = self.list.decode(llr.to(torch.float32))
        info = torch.where(f_ok[..., None], f_info, l_info.to(f_info.dtype))
        code = torch.where(f_ok[..., None], f_code, l_code.to(f_code.dtype))
        return info, code, f_ok | l_ok
