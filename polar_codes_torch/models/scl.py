"""CRC-aided successive-cancellation list (SCL) decoder.

The port of polar_codes_tpu/models/scl.py SCLDecoder for the path its
fast decode takes (`_decode_pallas_fast`): the tree levels up to
`kernel_span` run in the SCL subtree kernel K1 (ops/scl_kernel_bl.py), the
few wider levels above run here as torch glue in the same [w, S, B]
layout (the JAX `xla_node`), and the decision bits travel packed, one
int32 word per (position, codeword) with bit l = path l for L <= 32, and
W = ceil(L / 32) words [W, S, B] above (path l: bit l % 32 of word l //
32). The tail then checks the CRC on the packed words (one masked
XOR-reduction per tail bit and word, all paths at once; a detector that
is not affine, CMAC, checks the unpacked info bits of every path
instead), picks the best path whose check holds (the ML path if none
does), shifts its codeword out of its word and gathers the info bits.

Path metrics are LLR-based, higher is better; the list widens from one
path at metric 0 until forks have produced L candidates. Gathers are real
index gathers, so they are exact on any device.

Three families, as in the JAX package (`dtype`):
  float32  — f on the raw bits, decisions by the sign bit;
  int8     — the reference's SclFipChar: LLRs cast to int8 and held as
             int16 integers, saturating f/g (f_minsum_sat/g_update_sat),
             decisions llr < 0; metrics stay float32 and exact;
  bfloat16 — the channel LLRs rounded to bf16 on entry, bf16 state with f
             and g computed in float32 and rounded on store. A subtree call
             that widens the list (w_in < w_out) runs in float32 state, as
             the JAX package's widening kernels do; the others run bf16.
K1 runs each family as its own instantiation (ops/scl_kernel_bl.py).

L = 1 is plain SC: it decodes through the Fast-SSC decoder (kernel K3,
models/fastssc.py, in the decoder's dtype), as the JAX package does, and
recovers the path metric in its telescoped codeword form. Any other L
decodes through K1 (its shared-memory kernel up to scl_kernel_bl.MAX_LIST
paths where the state fits, its device-memory kernel for the rest).

The batch-first and batch-last XLA paths of the JAX package are not
ported: the plain version of K1 plus this glue is the port's reference,
and the JAX package's paths remain the parity reference of the tests.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.scl_kernel_bl import (
    SubtreeSchedule,
    build_schedule,
    family,
    n_words,
    packed_bipolar,
    plane,
    scl_subtree,
    take_packed,
    unpack,
)
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .detectors import Detector, Dummy
from .fastssc import FastSSCDecoder
from .fastssc import SubtreeFn as FastSubtreeFn
from .tree import CodeNode, NodeKind, build_tree

_NEG = -1.0e30  # metric of an inactive list slot
_ACTIVE_THRESHOLD = -1.0e29
# the decoder's dtype -> the dtype of the LLR state its glue and K1 hold
_STATE_DTYPES = {torch.float32: torch.float32, torch.int8: torch.int16,
                torch.bfloat16: torch.bfloat16}

SubtreeFn = Callable[[SubtreeSchedule, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def default_kernel_span(list_size: int, block_length: int) -> int:
    """The JAX package's default subtree span (512 at L <= 8)."""
    span = max(128, min(512, 4096 // max(list_size, 8)))
    return min(span, block_length)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over dim 1 of a [T, M, B] int32 tensor, as a halving tree."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        half = x.shape[1] // 2
        x = x[:, :half] ^ x[:, half:]
    return x[:, 0]


class SCLDecoder:
    """CRC-aided SCL decoder for one (N, frozen set) code.

    subtree_fn is the function that decodes one subtree (default: K1's
    wrapper, which runs the CUDA kernel on CUDA tensors and the plain
    version on CPU tensors); pass `scl_subtree_plain` to run the plain
    version on the card explicitly. At list_size=1 the decoder is the
    Fast-SSC decoder, and subtree_fn is K3's (`fastssc_subtree_plain`).
    dtype is torch.float32, torch.int8 or torch.bfloat16 (the module
    docstring says what each does).
    """

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        list_size: int = 8,
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype: torch.dtype = torch.float32,
        enum_span: int = 16,
        max_enum_k: Optional[int] = None,
        kernel_span: Optional[int] = None,
        device=DEFAULT_DEVICE,
        subtree_fn: Optional[Union[SubtreeFn, FastSubtreeFn]] = None,
    ):
        n = block_length.bit_length() - 1
        if (1 << n) != block_length:
            raise ValueError(f"block length {block_length} is not a power of 2")
        if list_size < 1:
            raise ValueError(f"list_size={list_size}: a list holds at least one path")
        if dtype not in _STATE_DTYPES:
            raise ValueError(f"SCLDecoder takes float32, int8 or bfloat16 LLRs, got {dtype}")
        if max_enum_k is None:
            max_enum_k = 4
        if list_size == 1:  # ENUM leaves would be less greedy than SC
            enum_span = 0
        if enum_span and (enum_span > 32 or max_enum_k > 5):
            raise NotImplementedError(
                "ENUM leaves are limited to span <= 32 and k <= 5")
        self.block_length = block_length
        self.list_size = int(list_size)
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.dtype = dtype
        self.state_dtype = _STATE_DTYPES[dtype]
        self.enum_span = enum_span
        self.max_enum_k = max_enum_k
        self.device = resolve_device(device)
        self._sc = None
        if self.list_size == 1:
            self._sc = FastSSCDecoder(
                block_length, self.frozen, systematic=True, dtype=dtype,
                kernel_span=kernel_span, device=self.device, subtree_fn=subtree_fn)
            kernel_span = self._sc.kernel_span
        self.kernel_span = (default_kernel_span(self.list_size, block_length)
                            if kernel_span is None else int(kernel_span))
        self.subtree_fn = scl_subtree if subtree_fn is None else subtree_fn
        self.tree: CodeNode = build_tree(
            block_length, self.frozen, enum_span=enum_span, max_enum_k=max_enum_k)
        self._schedules = {}
        self._info_pos_t = torch.as_tensor(self.info_pos, device=self.device)
        self._syndrome = self._syndrome_consts()

    @property
    def words(self) -> int:
        """int32 words of a packed position (one up to 32 paths)."""
        return n_words(self.list_size)

    # ---- constants -------------------------------------------------------

    def _syndrome_consts(self):
        """For a linear CRC: (index [T, M] of the codeword positions each
        tail-bit check reads, padded with N, which points at a zero row;
        g0 [T]). The check A @ info + g0 = 0 lifted to the systematic
        codeword. None without a tail, or for a detector that is not affine
        (CMAC): the tail then checks the unpacked paths."""
        det = self.detector
        if not det.tail_bits or not det._is_linear():
            return None
        A, g0 = det.check_matrix(self.info_length - det.tail_bits)
        rows = [self.info_pos[np.flatnonzero(A[t])] for t in range(det.tail_bits)]
        width = max(len(r) for r in rows)
        idx = np.full((det.tail_bits, width), self.block_length, np.int64)
        for t, r in enumerate(rows):
            idx[t, : len(r)] = r
        return (torch.as_tensor(idx, device=self.device),
                [int(v) for v in g0])

    def schedule(self, node: CodeNode, w_in: int) -> SubtreeSchedule:
        """The cached schedule of the subtree at `node` entered at w_in."""
        key = (node, w_in)
        sched = self._schedules.get(key)
        if sched is None:
            sched = build_schedule(node, w_in, self.list_size)
            self._schedules[key] = sched
        return sched

    def _check_input(self, llr: torch.Tensor) -> torch.Tensor:
        """[..., N] LLRs -> [B, N] in the state dtype: float32, bf16-rounded,
        or cast to int8 (as jnp.asarray(llr, int8) casts) and held in int16."""
        if llr.shape[-1] != self.block_length:
            raise ValueError(
                f"expected {self.block_length} LLRs per block, got {llr.shape[-1]}")
        if llr.device != self.device:
            raise ValueError(f"decoder lives on {self.device}, LLRs on {llr.device}")
        return llr.to(self.dtype).to(self.state_dtype).reshape(-1, self.block_length)

    # ---- glue above kernel_span ----------------------------------------------

    def _glue_node(self, node: CodeNode, llr, metrics):
        """llr [w, S, B], metrics [B, w] -> (word [S, B] or [W, S, B] i32,
        perm [B, w'], metrics [B, w']). Subtrees of span <= kernel_span, and
        leaves longer than it, go to the subtree function whole; a bf16 call
        that widens the list goes in float32."""
        if node.length <= self.kernel_span or node.kind != NodeKind.BRANCH:
            sched = self.schedule(node, llr.shape[0])
            if sched.w_out != sched.w_in and llr.dtype == torch.bfloat16:
                llr = llr.to(torch.float32)
            return self.subtree_fn(sched, llr.contiguous(), metrics.contiguous())
        fam = family(llr.dtype)
        half = node.length // 2
        a, b = llr[:, :half], llr[:, half:]
        left, p_left, metrics = self._glue_node(node.left, fam.f(a, b), metrics)
        w_mid = metrics.shape[-1]
        idx = p_left.T.to(torch.int64)[:, None, :].expand(w_mid, llr.shape[1], llr.shape[2])
        llr_g = torch.gather(llr, 0, idx)
        a, b = llr_g[:, :half], llr_g[:, half:]
        right, p_right, metrics = self._glue_node(
            node.right, fam.g(a, b, packed_bipolar(left, w_mid, self.words)), metrics)
        w_out = metrics.shape[-1]
        left = take_packed(left, p_right.T, w_out, self.words)
        perm = torch.gather(p_left, 1, p_right.to(torch.int64))
        return torch.cat([left ^ right, right], dim=-2), perm, metrics

    def decode_packed(self, llr: torch.Tensor):
        """llr [B, N] -> (packed codeword words [N, B] i32, or [W, N, B]
        above 32 paths; metrics [B, L])."""
        flat = self._check_input(llr)
        n_batch = flat.shape[0]
        metrics = torch.zeros((n_batch, 1), dtype=torch.float32, device=flat.device)
        word, _, metrics = self._glue_node(
            self.tree, flat.T.contiguous()[None], metrics)
        width = metrics.shape[-1]
        if width < self.list_size:  # tiny codes that never reach L paths
            metrics = torch.cat([metrics, torch.full(
                (n_batch, self.list_size - width), _NEG, device=flat.device)], dim=-1)
        return word, metrics

    # ---- public API --------------------------------------------------------

    def _decode_sc(self, llr: torch.Tensor):
        """L = 1: (codeword [..., N] uint8, metric [...]) through Fast-SSC,
        with the metric 0.5 * (sum(bipolar * llr) - sum(|llr|))."""
        codeword = self._sc.decode_to_codeword(llr)
        work = llr.to(torch.float32)  # llr in the state dtype
        bip = 1.0 - 2.0 * codeword.to(torch.float32)
        metric = 0.5 * ((bip * work).sum(-1) - work.abs().sum(-1))
        return codeword, metric

    def decode_paths(self, llr: torch.Tensor):
        """[..., N] LLRs -> (codewords [..., L, N] uint8, metrics [..., L],
        active [..., L])."""
        lead = llr.shape[:-1]
        if self._sc is not None:
            codeword, metric = self._decode_sc(self._check_input(llr).reshape(
                lead + (self.block_length,)))
            return (codeword[..., None, :], metric[..., None],
                    torch.ones(lead + (1,), dtype=torch.bool, device=llr.device))
        word, metrics = self.decode_packed(llr)
        planes = unpack(word, self.list_size, self.words)
        codewords = planes.permute(2, 0, 1).to(torch.uint8)
        codewords = codewords.reshape(lead + (self.list_size, self.block_length))
        metrics = metrics.reshape(lead + (self.list_size,))
        return codewords, metrics, metrics > _ACTIVE_THRESHOLD

    def decode(self, llr: torch.Tensor):
        """[..., N] LLRs -> (info bits [..., K] uint8, codeword [..., N]
        uint8, detector ok [...] bool): the best path whose CRC holds, or
        the ML path if none does."""
        lead = llr.shape[:-1]
        if self._sc is not None:
            codeword = self._sc.decode_to_codeword(self._check_input(llr).reshape(llr.shape))
            u = codeword if self.systematic else butterfly_transform(codeword)
            info = u.index_select(-1, self._info_pos_t)
            return info, codeword, self.detector.check(info)
        word, metrics = self.decode_packed(llr)
        active = metrics > _ACTIVE_THRESHOLD
        n_list, words = self.list_size, self.words
        if not self.systematic:
            # info bits live in the u domain: re-encode every path
            planes = unpack(word, n_list, words)
            u = butterfly_transform(planes.permute(2, 0, 1))
            info_all = u.index_select(-1, self._info_pos_t)
            ok_all = self.detector.check(info_all) & active
        elif self._syndrome is not None:
            idx, g0 = self._syndrome
            ext = torch.cat([word, torch.zeros_like(word[..., :1, :])], dim=-2)
            taken = ext.reshape(words, -1, ext.shape[-1])[:, idx]  # [W, T, M, B]
            # [W, T, B]: bit l % 32 of word l // 32 = path l's parity
            parity = _xor_reduce(taken.flatten(0, 1)).unflatten(0, taken.shape[:2])
            bad = torch.zeros_like(parity[:, 0])
            for t, g in enumerate(g0):
                bad = bad | (~parity[:, t] if g else parity[:, t])
            lanes = torch.arange(n_list, device=word.device)
            fails = (bad[lanes >> 5] >> (lanes & 31)[:, None]) & 1  # [L, B]
            ok_all = (fails.T == 0) & active
        elif self.detector.tail_bits:
            # a detector that is not affine (CMAC): unpack the info bits of
            # every path and check them all in one call, [L, B, K] -> [B, L]
            info_word = word.index_select(-2, self._info_pos_t)  # [K, B] or [W, K, B]
            info_all = unpack(info_word, n_list, words)
            ok_all = self.detector.check(info_all.transpose(1, 2).to(torch.uint8)).T & active
        else:
            ok_all = active
        if self.detector.tail_bits:
            any_ok = ok_all.any(dim=-1)
            best_ok = torch.where(ok_all, metrics, _NEG).argmax(dim=-1)
            sel = torch.where(any_ok, best_ok, metrics.argmax(dim=-1))
            detector_ok = any_ok
        else:
            sel = metrics.argmax(dim=-1)
            detector_ok = torch.ones_like(sel, dtype=torch.bool)
        codeword = plane(word, sel, words).T.to(torch.uint8)
        if self.systematic:
            info = codeword.index_select(1, self._info_pos_t)
        else:
            info = torch.gather(info_all, 1, sel[:, None, None].expand(
                -1, 1, info_all.shape[-1]))[:, 0].to(torch.uint8)
        return (info.reshape(lead + (self.info_length,)),
                codeword.reshape(lead + (self.block_length,)),
                detector_ok.reshape(lead))
