"""Depth-first bit-flip (SC-Flip) decoder, the port of
polar_codes_tpu/models/depthfirst.py.

An SC pass records each information decision's reliability |LLR|; while
the CRC fails and trials remain, the frame is decoded again with one
decision flipped: trial t flips, in every row, that row's t-th weakest
decision of the first pass (a stable argsort, so ties go to the earlier
decision). A row keeps the first codeword whose check passes. Every trial
decodes the whole [B, N] batch; rows that are already done cost nothing
extra. The decode tree collapses only rate-0 subtrees, so every
information decision is a span-1 leaf.

The JAX package runs a pass as one XLA program; here it is a walk over the
tree in eager torch (a few operations per node on the whole batch), the
port's plain path: the JAX package has no kernel for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.fg import f_minsum, g_update
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .detectors import Detector, Dummy
from .tree import CodeNode, NodeKind, build_tree


def _sign(x: torch.Tensor) -> torch.Tensor:
    """-1 where the sign bit is set (-0.0 too), else +1."""
    return 1.0 - 2.0 * torch.signbit(x).to(x.dtype)


class DepthFirstDecoder:
    """CRC-gated SC-Flip decoder with `trial_limit` decoding passes. Its
    constants live on `device` (the card unless the caller asks for the
    CPU); inputs must be there too."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        trial_limit: int = 8,
        device=DEFAULT_DEVICE,
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
        self.trial_limit = max(int(trial_limit), 1)
        self.device = resolve_device(device)
        # bit-level decisions: only rate-0 subtrees collapse
        self.tree: CodeNode = build_tree(
            block_length, self.frozen, allowed=frozenset({NodeKind.RATE0}))
        self._info_pos_t = torch.as_tensor(self.info_pos, device=self.device)

    # ---- one SC pass with flips ------------------------------------------

    def _node(self, node: CodeNode, llr, flips, rels: List[torch.Tensor]):
        """llr [B, span] -> bipolar decisions [B, span]; appends each info
        decision's |llr| [B] to rels. flips [B, K] multiplies the sign of
        info decision k."""
        if node.kind == NodeKind.RATE0:
            return torch.ones_like(llr)
        if node.length == 1:  # an info bit
            k = len(rels)
            rels.append(llr[:, 0].abs())
            return _sign(llr) * flips[:, k : k + 1]
        half = node.length // 2
        a, b = llr[:, :half], llr[:, half:]
        left = self._node(node.left, f_minsum(a, b), flips, rels)
        right = self._node(node.right, g_update(a, b, left), flips, rels)
        return torch.cat([left * right, right], dim=1)

    def _pass(self, llr, flips):
        """(codeword [B, N] uint8, reliabilities [B, K]) of one pass."""
        rels: List[torch.Tensor] = []
        bits = self._node(self.tree, llr, flips, rels)
        assert len(rels) == self.info_length
        return torch.signbit(bits).to(torch.uint8), torch.stack(rels, dim=1)

    def _extract(self, codeword: torch.Tensor) -> torch.Tensor:
        u = codeword if self.systematic else butterfly_transform(codeword)
        return u.index_select(-1, self._info_pos_t)

    # ---- public API ------------------------------------------------------

    def decode(self, llr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[..., N] channel LLRs -> (info [..., K] uint8, codeword [..., N]
        uint8, detector ok [...] bool)."""
        if llr.shape[-1] != self.block_length:
            raise ValueError(
                f"expected {self.block_length} LLRs per block, got {llr.shape[-1]}")
        if llr.device != self.device:
            raise ValueError(f"decoder lives on {self.device}, LLRs on {llr.device}")
        lead = llr.shape[:-1]
        flat = llr.to(torch.float32).reshape(-1, self.block_length)
        n_batch = flat.shape[0]
        ones = torch.ones((n_batch, self.info_length), device=self.device)
        best, rels = self._pass(flat, ones)
        tail = self.detector.tail_bits
        done = (self.detector.check(self._extract(best)) if tail
                else torch.ones(n_batch, dtype=torch.bool, device=self.device))
        if tail and self.trial_limit > 1:
            order = torch.argsort(rels, dim=1, stable=True)  # weakest decision first
            lanes = torch.arange(self.info_length, device=self.device)
            for t in range(self.trial_limit - 1):
                flips = 1.0 - 2.0 * (lanes == order[:, t : t + 1]).to(torch.float32)
                cw_t, _ = self._pass(flat, flips)
                ok_t = self.detector.check(self._extract(cw_t))
                take = ok_t & ~done
                best = torch.where(take[:, None], cw_t, best)
                done = done | ok_t
        info = self._extract(best)
        return (info.reshape(lead + (self.info_length,)),
                best.reshape(lead + (self.block_length,)), done.reshape(lead))
