"""Fast-SSC decoder (L = 1), batched over codewords.

The port of polar_codes_tpu/models/fastssc.py FastSSCDecoder on the path
of its Pallas backend (`build_fs_hybrid_decode`): subtrees of span <=
`kernel_span` (default min(1024, N), as in the JAX package) run in the
Fast-SSC subtree kernel K3 (ops/fastssc_kernel.py); the few wider levels
above run here as torch glue in the same [span, B] layout (the JAX
`xla_node`), with the ZeroR shortcut. Leaves longer than `kernel_span` go
to the kernel whole.

Three families, as in the JAX package:
  dtype=torch.float32  — f on the raw bits, decisions by the sign bit;
  dtype=torch.bfloat16 — LLRs rounded to bf16 on entry, bf16 state (f, g
                         and ZeroR rounded once on store, leaves in
                         float32), decisions by the sign bit; the glue
                         above kernel_span runs in bf16 too, as the JAX
                         hybrid's does;
  dtype=torch.int8     — LLRs in [-127, 127], saturating fip_char
                         arithmetic, decisions llr < 0.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.fastssc_kernel import (
    FastSSCSchedule,
    build_schedule,
    family,
    fastssc_subtree,
)
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .detectors import Detector, Dummy
from .tree import CodeNode, NodeKind, build_tree

SubtreeFn = Callable[[FastSSCSchedule, torch.Tensor, bool], torch.Tensor]


class FastSSCDecoder:
    """Successive-cancellation decoder with Fast-SSC leaf shortcuts.

    subtree_fn decodes one subtree (default: K3's wrapper, which runs the
    CUDA kernel on CUDA tensors and the plain version on CPU tensors);
    pass `fastssc_subtree_plain` to run the plain version on the card."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype: torch.dtype = torch.float32,
        kernel_span: Optional[int] = None,
        device=DEFAULT_DEVICE,
        subtree_fn: Optional[SubtreeFn] = None,
    ):
        n = block_length.bit_length() - 1
        if (1 << n) != block_length:
            raise ValueError(f"block length {block_length} is not a power of 2")
        self._fam = family(dtype)  # raises for a dtype other than float32, bf16 or int8
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.dtype = dtype
        self.kernel_span = (min(1024, block_length) if kernel_span is None
                            else int(kernel_span))
        self.subtree_fn = fastssc_subtree if subtree_fn is None else subtree_fn
        self.tree: CodeNode = build_tree(block_length, self.frozen)
        self._schedules = {}
        self.device = resolve_device(device)
        self._info_pos_t = torch.as_tensor(self.info_pos, device=self.device)

    def schedule(self, node: CodeNode) -> FastSSCSchedule:
        """The cached schedule of the subtree at `node`."""
        sched = self._schedules.get(node)
        if sched is None:
            sched = build_schedule(node)
            self._schedules[node] = sched
        return sched

    def _glue_node(self, node: CodeNode, llr: torch.Tensor) -> torch.Tensor:
        """llr [span, B] -> bipolar state [span, B], or uint8 bits when the
        node is the root and goes to the subtree function whole."""
        if node.length <= self.kernel_span or node.kind != NodeKind.BRANCH:
            return self.subtree_fn(self.schedule(node), llr.contiguous(),
                                   node.length == self.block_length)
        fam = self._fam
        half = node.length // 2
        a, b = llr[:half], llr[half:]
        if node.left.kind == NodeKind.RATE0:
            right = self._glue_node(node.right, fam.zero_r(a, b))
            return torch.cat([right, right], dim=0)
        left = self._glue_node(node.left, fam.f(a, b))
        right = self._glue_node(node.right, fam.g(a, b, left))
        return torch.cat([left * right, right], dim=0)

    def decode_to_codeword(self, llr: torch.Tensor) -> torch.Tensor:
        """[..., N] channel LLRs -> [..., N] uint8 codeword bits."""
        if llr.shape[-1] != self.block_length:
            raise ValueError(
                f"expected {self.block_length} LLRs per block, got {llr.shape[-1]}")
        if llr.device != self.device:
            raise ValueError(f"decoder lives on {self.device}, LLRs on {llr.device}")
        lead = llr.shape[:-1]
        flat = llr.to(self.dtype).reshape(-1, self.block_length)
        out = self._glue_node(self.tree, flat.T.contiguous())
        if out.dtype != torch.uint8:  # root above kernel_span
            out = (out < 0).to(torch.uint8)
        return out.T.reshape(lead + (self.block_length,))

    def extract(self, codeword: torch.Tensor) -> torch.Tensor:
        """Info bits of [..., N] codewords (re-encoded first if not
        systematic: the transform is an involution)."""
        if not self.systematic:
            codeword = butterfly_transform(codeword)
        return codeword.index_select(-1, self._info_pos_t)

    def decode(self, llr: torch.Tensor):
        """[..., N] channel LLRs -> (info bits [..., K] uint8, codeword
        [..., N] uint8, detector ok [...] bool)."""
        codeword = self.decode_to_codeword(llr)
        info = self.extract(codeword)
        return info, codeword, self.detector.check(info)
