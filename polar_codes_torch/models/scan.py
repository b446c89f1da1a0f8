"""SCAN soft-output decoders: fixed-sweep SCAN and CRC-gated Fast-SSCAN.

The port of polar_codes_tpu/models/scan.py on the path of its Pallas
backend: ScanDecoder runs all sweeps in the fused kernel K4, and
FastSScanDecoder runs one sweep per call of the stepped kernel K5, with
the node memory carried as a packed [M, B] buffer, because its CRC gate
reads the codeword between sweeps (ops/scan_kernel.py). The tree collapses
only rate-0 (beta +inf) and rate-1 (beta 0) subtrees. Decisions are
`total < 0`, total = llr + beta. A code whose whole tree is one leaf has
no sweep to run: its beta is +inf or 0 directly.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.scan_kernel import build_schedule, scan_fused, scan_step
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .detectors import Detector, Dummy
from .tree import CodeNode, NodeKind, build_tree

SCAN_LEAF_KINDS = frozenset({NodeKind.RATE0, NodeKind.RATE1})


class ScanDecoder:
    """Iterative SCAN decoder with soft (extrinsic) output. fused_fn is K4's
    wrapper by default; pass `scan_fused_plain` to run the plain version
    on the card."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        iterations: int = 1,
        device=DEFAULT_DEVICE,
        fused_fn: Optional[Callable] = None,
        step_fn: Optional[Callable] = None,
    ):
        n = block_length.bit_length() - 1
        if (1 << n) != block_length:
            raise ValueError(f"block length {block_length} is not a power of 2")
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.iterations = max(int(iterations), 1)
        self.tree: CodeNode = build_tree(block_length, self.frozen, allowed=SCAN_LEAF_KINDS)
        self.sched = build_schedule(self.tree) if self.tree.kind == NodeKind.BRANCH else None
        self.fused_fn = scan_fused if fused_fn is None else fused_fn
        self.step_fn = scan_step if step_fn is None else step_fn
        self.device = resolve_device(device)
        self._info_pos_t = torch.as_tensor(self.info_pos, device=self.device)

    def _flat(self, llr: torch.Tensor) -> torch.Tensor:
        """[..., N] -> [N, B] float32 in the kernels' layout."""
        if llr.shape[-1] != self.block_length:
            raise ValueError(
                f"expected {self.block_length} LLRs per block, got {llr.shape[-1]}")
        if llr.device != self.device:
            raise ValueError(f"decoder lives on {self.device}, LLRs on {llr.device}")
        return llr.to(torch.float32).reshape(-1, self.block_length).T.contiguous()

    def _leaf_beta(self, llr: torch.Tensor) -> torch.Tensor:
        """The beta of a single-leaf tree: +inf (all frozen) or 0."""
        value = float("inf") if self.tree.kind == NodeKind.RATE0 else 0.0
        return torch.full(llr.shape, value, dtype=torch.float32, device=llr.device)

    def decode_soft(self, llr: torch.Tensor, iterations: Optional[int] = None):
        """[..., N] channel LLRs -> (total LLRs llr + beta [..., N],
        extrinsic beta [..., N]) after the configured sweeps."""
        x = llr.to(torch.float32)
        sweeps = self.iterations if iterations is None else int(iterations)
        if self.sched is None:
            beta = self._leaf_beta(x) if sweeps else torch.zeros_like(x)
        else:
            beta = self.fused_fn(self.sched, self._flat(x), sweeps).T.reshape(x.shape)
        return x + beta, beta

    def extract(self, codeword: torch.Tensor) -> torch.Tensor:
        u = codeword if self.systematic else butterfly_transform(codeword)
        return u.index_select(-1, self._info_pos_t)

    def decode_to_codeword(self, llr: torch.Tensor) -> torch.Tensor:
        total, _ = self.decode_soft(llr)
        return (total < 0).to(torch.uint8)

    def decode(self, llr: torch.Tensor):
        """[..., N] channel LLRs -> (info [..., K], codeword [..., N], ok)."""
        codeword = self.decode_to_codeword(llr)
        info = self.extract(codeword)
        return info, codeword, self.detector.check(info)


class FastSScanDecoder(ScanDecoder):
    """Tree-specialised SCAN with CRC-gated sweeps (FastSscanFloat): up to
    `iterations` sweeps through K5 (step_fn; `scan_step_plain` runs the
    plain version on the card). A row's first sweep whose CRC holds
    freezes its output; rows that never pass keep the last sweep's. Once
    every row has passed, the remaining sweeps would change nothing, and
    they are not run."""

    def decode(self, llr: torch.Tensor):
        x = llr.to(torch.float32)
        lead = x.shape[:-1]
        done = torch.zeros(lead, dtype=torch.bool, device=x.device)
        best = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
        flat = mem = None
        if self.sched is not None:
            flat = self._flat(x)
            mem = torch.zeros((self.sched.mem_rows, flat.shape[1]), device=x.device)
        for sweep in range(self.iterations):
            if self.sched is None:
                beta = self._leaf_beta(x)
            else:
                beta, mem = self.step_fn(self.sched, flat, mem)
                beta = beta.T.reshape(x.shape)
            codeword = ((x + beta) < 0).to(torch.uint8)
            ok = self.detector.check(self.extract(codeword))
            best = torch.where((ok & ~done)[..., None], codeword, best)
            done = done | ok
            last = sweep == self.iterations - 1
            if last or bool(done.all()):
                # rows that never passed keep the last sweep's estimate
                best = torch.where(done[..., None], best, codeword)
                break
        return self.extract(best), best, done
