"""SC and SCL decoders for very large block lengths, one chunk at a time.

The port of polar_codes_tpu/models/large.py (the "scan" schedule). The code
tree is cut at chunk span M. The T = N / M chunks are decoded in natural
order; above them sits one LLR buffer and one partial-sum buffer per outer
tree stage s = 1..log2(T), of span N >> s (the live SC frontier, O(N)
state). Before chunk t, stage s is refreshed when t is a multiple of
2^(S-s): g for a right child, f for a left one; after it, trailing_ones(t)
partial-sum combines climb back up and one store keeps the result. In the
JAX package a lax.scan runs this with predicated branches; here t is a
Python integer, so the triggers, the f/g choice and the climb depth are
decided on the host and only the work that is due is launched.

Each chunk is decoded by its class, found once on the host from its frozen
mask: mixed chunks by the masked chunk kernels (K6 for SC, K7 for SCL,
ops/large_kernel.py), and with `fast_chunks` pure chunks (all frozen, all
info, repetition, single parity check) by closed forms: the Fast-SSC rules
for SC, the SSCL leaf rules for SCL (through K1, ops/scl_kernel_bl.py, on
a one-leaf schedule).

SCL specifics: the list axis rides along every outer buffer ([B, L, span]
LLRs, stored in `carry_dtype`; bits packed one int32 word per position,
bit l = path l, combined by XOR; above 32 paths W = ceil(L / 32) words
[B, W, span], path l in bit l % 32 of word l // 32, whose gathers take
each path's word by l >> 5 and its bit by l & 31, all paths at once). Any
L >= 1 decodes at any chunk (L = 1 keeps the list machinery, as the JAX
class does): K7 and K1 hold one codeword's list in shared memory where it
fits, and in a device-memory scratch (csrc/scl_wide.cu) where it does not
(every L > 128, and L <= 128 on chunks too large for it). The forks
of a chunk compose into one perm, and the outer buffers are not gathered
through it at once: each stage keeps a lag perm ([B, L], composed with
every chunk perm) and is gathered through it only when it is read (a g
refresh or a climb). The chunk segments are gathered once at the end,
through the composition of the later chunk perms, and the top log2(T)
butterfly stages join them.

dtype=torch.int8 is the reference's fip_char family, as in the JAX
package: integer-valued LLRs in float32 (LargeSC takes them unclipped,
LargeSCL clips them to [-127, 127]), the saturating pair f_minsum_sat /
g_update_sat in the outer stages and the char family of the chunk kernels
inside, decisions llr < 0. Every chunk is then mixed (the closed forms and
the sub-block rules would sum without the staged saturation), so an int8
decode runs only the chunk kernels K6 or K7.

LargeSCLDecoder(schedule="tree") walks the code tree instead (JAX
`_decode_paths_tree`): leaves at their maximal pure span take the SSCL
leaf rules through K1 on a one-leaf schedule, mixed subtrees of chunk span
go to K7 as chunk offset / M, and the branch nodes above run f and g in
float32 with the perms of their children gathered and composed in torch.
It takes float32 only, needs fast_chunks, and ignores carry_dtype, as in
the JAX package.

The JAX constructors' `backend` and `unroll` arguments only shape the JAX
program; the port has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform, butterfly_transform_bipolar
from ..ops.fg import f_minsum, f_minsum_sat, g_update, g_update_sat
from ..ops.large_kernel import _SUB_KINDS, _sub_leaf, masked_sc_chunk, masked_scl_chunk
from ..ops.scl_kernel_bl import build_schedule, pack_planes, scl_subtree
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .detectors import Detector, Dummy
from .scl import _NEG, SCLDecoder
from .scl import SubtreeFn as SclSubtreeFn
from .tree import CodeNode, NodeKind, build_tree

ScChunkFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
SclChunkFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _check_pow2(value: int, name: str) -> int:
    n = value.bit_length() - 1
    if value <= 0 or (1 << n) != value:
        raise ValueError(f"{name} {value} is not a power of 2")
    return n


def _frozen_mask_chunks(block_length: int, frozen, chunk: int) -> np.ndarray:
    mask = np.zeros(block_length, dtype=bool)
    mask[np.asarray(frozen, dtype=np.int64)] = True
    return mask.reshape(block_length // chunk, chunk)


# chunk classes: the closed form that decodes a pure chunk or sub-block
_MIXED, _RATE0, _RATE1, _REP, _SPC = range(5)
_CLASS_KINDS = {code: kind for code, kind in enumerate(_SUB_KINDS) if kind is not None}


def _classify_chunks(mask_chunks) -> np.ndarray:
    """[T, M] frozen masks -> [T] int32 class codes."""
    cls = np.full(len(mask_chunks), _MIXED, dtype=np.int32)
    for i, m in enumerate(mask_chunks):
        if m.all():
            cls[i] = _RATE0
        elif not m.any():
            cls[i] = _RATE1
        elif m[:-1].all() and not m[-1]:
            cls[i] = _REP
        elif m[0] and not m[1:].any() and m.size >= 4:
            # span >= 4: the SSCL SPC rule expands the four weakest bits
            cls[i] = _SPC
    return cls


def _trailing_ones(t: int) -> int:
    return ((t + 1) & -(t + 1)).bit_length() - 1


class _Chunked:
    """Host data shared by both decoders: the code, the chunk masks and
    classes, and their copies on the device."""

    def _setup(self, block_length, frozen_bit_positions, systematic, detector,
               dtype, chunk, fast_chunks, device):
        if dtype not in (torch.float32, torch.int8):
            raise ValueError(f"{type(self).__name__} takes float32 or int8 LLRs, got {dtype}")
        self.dtype = dtype
        self.family = "char" if dtype == torch.int8 else "float32"
        self._fg = (f_minsum_sat, g_update_sat) if dtype == torch.int8 else (f_minsum, g_update)
        n = _check_pow2(block_length, "block length")
        chunk = min(chunk, block_length)
        self.block_length = block_length
        self.chunk = chunk
        self.outer_stages = n - _check_pow2(chunk, "chunk")
        self.n_chunks = block_length // chunk
        self.fast_chunks = bool(fast_chunks)
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.device = resolve_device(device)
        self.mask_chunks = _frozen_mask_chunks(block_length, self.frozen, chunk)
        # int8: every chunk mixed, to keep the staged saturation
        self.classes = (_classify_chunks(self.mask_chunks)
                        if self.fast_chunks and self.family == "float32"
                        else np.full(self.n_chunks, _MIXED, np.int32))
        self._masks_t = torch.as_tensor(self.mask_chunks.astype(np.uint8),
                                        device=self.device)
        self._info_pos_t = torch.as_tensor(self.info_pos, device=self.device)

    def _check_input(self, llr: torch.Tensor) -> torch.Tensor:
        if llr.shape[-1] != self.block_length:
            raise ValueError(
                f"expected {self.block_length} LLRs per block, got {llr.shape[-1]}")
        if llr.device != self.device:
            raise ValueError(f"decoder lives on {self.device}, LLRs on {llr.device}")
        return llr.to(torch.float32).reshape(-1, self.block_length)


class LargeSCDecoder(_Chunked):
    """Successive-cancellation decoder for large N, chunk by chunk.

    chunk_fn decodes one mixed chunk (default: K6's wrapper, which runs the
    CUDA kernel on CUDA tensors and the plain version on CPU tensors); pass
    `masked_sc_chunk_plain` to run the plain version on the card. It is
    called as chunk_fn(llr, mask, family=...)."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype: torch.dtype = torch.float32,
        chunk: int = 2048,
        fast_chunks: bool = True,
        device=DEFAULT_DEVICE,
        chunk_fn: Optional[ScChunkFn] = None,
    ):
        self._setup(block_length, frozen_bit_positions, systematic, detector, dtype,
                    chunk, fast_chunks, device)
        self.chunk_fn = masked_sc_chunk if chunk_fn is None else chunk_fn

    # ---- pure-chunk closed forms (Fast-SSC leaf rules at chunk span) -----

    @staticmethod
    def _hard(llr):
        return 1.0 - 2.0 * torch.signbit(llr).to(llr.dtype)

    def _chunk(self, t: int, llr: torch.Tensor):
        """Chunk t: llr [B, M] -> (x, u) [B, M] bipolar."""
        cls = int(self.classes[t])
        if cls == _MIXED:
            return self.chunk_fn(llr.contiguous(), self._masks_t[t], family=self.family)
        if cls == _RATE0:
            ones = torch.ones_like(llr)
            return ones, ones
        if cls == _RATE1:
            x = self._hard(llr)
            return x, butterfly_transform_bipolar(x)
        if cls == _REP:
            u_last = self._hard(llr.sum(dim=-1, keepdim=True))
            u = torch.cat([torch.ones_like(llr[:, :-1]), u_last], dim=-1)
            return u_last.expand_as(llr), u
        hard = self._hard(llr)  # SPC
        parity_neg = torch.prod(hard, dim=-1) < 0
        weakest = torch.argmin(llr.abs(), dim=-1)
        iota = torch.arange(llr.shape[-1], device=llr.device)
        flip = (iota == weakest[:, None]) & parity_neg[:, None]
        x = torch.where(flip, -hard, hard)
        return x, butterfly_transform_bipolar(x)

    # ---- outer loop ------------------------------------------------------

    def _decode_u(self, flat: torch.Tensor) -> torch.Tensor:
        """[B, N] channel LLRs -> u-hat bipolar [B, N]."""
        n_len, n_outer = self.block_length, self.outer_stages
        if self.n_chunks == 1:
            return self.chunk_fn(flat.contiguous(), self._masks_t[0], family=self.family)[1]
        f_fn, g_fn = self._fg
        llrs = [None] * n_outer
        bits = [None] * n_outer
        u_chunks = []
        for t in range(self.n_chunks):
            prev = flat
            for s in range(1, n_outer + 1):
                if t % (1 << (n_outer - s)) == 0:
                    span = n_len >> s
                    a, b = prev[:, :span], prev[:, span:]
                    llrs[s - 1] = (g_fn(a, b, bits[s - 1]) if (t >> (n_outer - s)) & 1
                                   else f_fn(a, b))
                prev = llrs[s - 1]
            x, u = self._chunk(t, prev)
            u_chunks.append(u)
            climb = min(_trailing_ones(t), n_outer)
            for c in range(climb):
                x = torch.cat([bits[n_outer - c - 1] * x, x], dim=-1)
            if climb < n_outer:
                bits[n_outer - climb - 1] = x
        return torch.cat(u_chunks, dim=-1)

    # ---- public API ------------------------------------------------------

    def decode_to_codeword(self, llr: torch.Tensor) -> torch.Tensor:
        """[..., N] channel LLRs -> [..., N] codeword bits uint8."""
        lead = llr.shape[:-1]
        u = self._decode_u(self._check_input(llr))
        codeword = butterfly_transform(torch.signbit(u).to(torch.uint8))
        return codeword.reshape(lead + (self.block_length,))

    def decode(self, llr: torch.Tensor):
        """[..., N] LLRs -> (info [..., K] uint8, codeword [..., N] uint8,
        detector ok [...] bool)."""
        codeword = self.decode_to_codeword(llr)
        u = codeword if self.systematic else butterfly_transform(codeword)
        info = u.index_select(-1, self._info_pos_t)
        ok = (self.detector.check(info) if self.detector.tail_bits
              else torch.ones(info.shape[:-1], dtype=torch.bool, device=info.device))
        return info, codeword, ok


# ---- helpers of the SCL glue: packed words [..., S] i32 (one word a
# position, L <= 32) or [..., W, S] (W = ceil(L / 32) words, path l in bit
# l % 32 of word l // 32), perms [..., L] --------------------------------
# Each is a handful of whole-tensor ops, whatever L: the glue launches
# them at every chunk step, so their count, not their bytes, sets its time.

def _take_paths(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """[B, L, S] gathered along the path axis: out[:, l] = x[:, perm[:, l]]."""
    return torch.gather(x, 1, perm[:, :, None].expand(-1, -1, x.shape[2]))


def _planes(word: torch.Tensor, perm: torch.Tensor, words: int = 1) -> torch.Tensor:
    """[..., L, S] {0,1}: plane l of the output is plane perm[..., l] of
    the packed words ([..., S], or [..., W, S]); above one word each plane
    gathers its word by perm >> 5 and shifts by perm & 31, all at once."""
    if words == 1:
        return (word.unsqueeze(-2) >> perm.unsqueeze(-1)) & 1
    idx = (perm >> 5).unsqueeze(-1).expand(perm.shape + word.shape[-1:])
    sel = torch.gather(word, -2, idx)  # [..., L, S]: each plane's word
    return (sel >> (perm & 31).to(torch.int32).unsqueeze(-1)) & 1


def _take_word(word: torch.Tensor, perm: torch.Tensor, words: int = 1) -> torch.Tensor:
    """Packed words ([..., S] or [..., W, S]) gathered by perm [..., L]
    (out plane l = in plane perm[..., l]), packed again."""
    planes = _planes(word, perm, words)
    if words == 1:
        lanes = torch.arange(perm.shape[-1], device=word.device)[:, None]
        return (planes << lanes).sum(-2).to(torch.int32)
    return pack_planes(planes.movedim(-2, 0), words).movedim(0, -2)


def _compose(p_early: torch.Tensor, p_late: torch.Tensor) -> torch.Tensor:
    """Final slots -> the slots before p_early: p_early[p_late] (p_early
    may carry leading stage dims)."""
    return torch.gather(p_early, -1, p_late.expand_as(p_early))


class LargeSCLDecoder(_Chunked, SCLDecoder):
    """Bitwise CA-SCL decoder for large N, chunk by chunk.

    Mixed chunks run exact per-bit forks (2 candidates per bit); with
    `fast_chunks` pure chunks take the SSCL leaf rules, and `subblock`
    (default 16, with fast_chunks) extends that dispatch into the mixed
    chunks at the sub-block span; int8 turns both off. `carry_dtype` (None = float32, or
    torch.bfloat16) is the storage of the outer-stage LLRs; f and g compute
    in float32 and round on store. decode (inherited from SCLDecoder)
    returns the best path whose CRC holds, or the ML path if none does.

    chunk_fn decodes one mixed chunk (default: K7's wrapper; called as
    chunk_fn(llr, mask, metrics, sub_cls, family=...)) and subtree_fn one
    pure chunk, or on the tree schedule one pure leaf (default: K1's
    wrapper); pass `masked_scl_chunk_plain` and `scl_subtree_plain` to run
    the plain versions on the card.

    schedule is "scan" (None) or "tree" (the module docstring says what
    each does)."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        list_size: int = 8,
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype: torch.dtype = torch.float32,
        chunk: int = 256,
        fast_chunks: bool = True,
        subblock: Optional[int] = 16,
        schedule: Optional[str] = None,
        carry_dtype: Optional[torch.dtype] = None,
        device=DEFAULT_DEVICE,
        chunk_fn: Optional[SclChunkFn] = None,
        subtree_fn: Optional[SclSubtreeFn] = None,
    ):
        schedule = "scan" if schedule is None else schedule
        if schedule not in ("tree", "scan"):
            raise ValueError(f"unknown schedule {schedule}")
        if schedule == "tree" and not fast_chunks:
            raise ValueError(
                "schedule='tree' uses SSCL fast-leaf rules and cannot honor "
                "fast_chunks=False; use schedule='scan' for the exact per-bit decoder")
        if schedule == "tree" and dtype == torch.int8:
            raise ValueError("schedule='tree' does not support dtype=int8; use "
                             "schedule='scan' (the int8-qualified path)")
        if list_size < 1:
            raise ValueError(f"list_size={list_size}: a list holds at least one path")
        if carry_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError("carry_dtype is None, torch.float32 or torch.bfloat16")
        # deliberately not SCLDecoder.__init__: it builds the unrolled tree
        self._setup(block_length, frozen_bit_positions, systematic, detector, dtype,
                    chunk, fast_chunks, device)
        self.list_size = int(list_size)
        self.carry_dtype = carry_dtype
        self._sc = None
        self.tree = None
        if (subblock and self.fast_chunks and self.family == "float32"
                and subblock < self.chunk):
            _check_pow2(subblock, "subblock")
            self.subblock = int(subblock)
            self.sub_classes = np.stack([
                _classify_chunks(list(m.reshape(-1, self.subblock)))
                for m in self.mask_chunks])  # [T, chunk // subblock]
            self._subs_t = torch.as_tensor(self.sub_classes, device=self.device)
        else:
            self.subblock = None
            self.sub_classes = np.zeros((self.n_chunks, 1), np.int32)
            self._subs_t = None
        self.chunk_fn = masked_scl_chunk if chunk_fn is None else chunk_fn
        self.subtree_fn = scl_subtree if subtree_fn is None else subtree_fn
        self._leaf_scheds = {
            cls: build_schedule(_sub_leaf(kind, self.chunk), self.list_size, self.list_size)
            for cls, kind in _CLASS_KINDS.items()}
        self.schedule = schedule
        self.sched_tree = None
        if schedule == "tree":
            self.sched_tree = build_tree(block_length, self.frozen)
            self._tree_scheds = {  # the leaves outside the chunk-span subtrees
                leaf: build_schedule(leaf, self.list_size, self.list_size)
                for leaf in self.sched_tree.leaves() if leaf.length >= self.chunk}
        self._syndrome = self._syndrome_consts()

    # ---- one chunk -------------------------------------------------------

    def _chunk(self, t: int, llr: torch.Tensor, metrics: torch.Tensor):
        """Chunk t: llr [B, L, M] f32 -> (word [B, M] i32, or [B, W, M];
        perm [B, L] i64; metrics [B, L])."""
        cls = int(self.classes[t]) if self.n_chunks > 1 else _MIXED
        if cls == _MIXED:
            sub = None if self._subs_t is None else self._subs_t[t]
            word, perm, metrics = self.chunk_fn(llr.contiguous(), self._masks_t[t],
                                                metrics, sub, family=self.family)
            return word, perm.to(torch.int64), metrics
        return self._leaf(self._leaf_scheds[cls], llr, metrics)

    def _leaf(self, sched, llr: torch.Tensor, metrics: torch.Tensor):
        """A one-leaf schedule through K1: llr [B, L, S] -> the batch-first
        word ([B, S], or [B, W, S] from K1's [W, S, B]), perm, metrics. K1
        gets llr as an [L, S, B] view (K1's device-memory kernel reads it
        in place, each codeword's paths side by side)."""
        word, perm, metrics = self.subtree_fn(sched, llr.permute(1, 2, 0), metrics)
        return word.movedim(-1, 0), perm.to(torch.int64), metrics

    # ---- outer loop ------------------------------------------------------

    def decode_packed(self, llr: torch.Tensor):
        """llr [B, N] -> (packed codeword word [N, B] i32, or [W, N, B]
        above 32 paths; metrics [B, L])."""
        flat = self._check_input(llr)
        if self.family == "char":
            flat = flat.clamp(-127.0, 127.0)
        f_fn, g_fn = self._fg
        n_batch, n_list, words = flat.shape[0], self.list_size, self.words
        n_len, n_outer = self.block_length, self.outer_stages
        cdt = self.carry_dtype or torch.float32
        metrics = torch.full((n_batch, n_list), _NEG, device=flat.device)
        metrics[:, 0] = 0.0
        chan = flat[:, None, :].expand(n_batch, n_list, n_len)
        if self.schedule == "tree":
            word, _, metrics = self._tree_node(self.sched_tree, chan, metrics)
            return word.movedim(0, -1).contiguous(), metrics
        if self.n_chunks == 1:
            word, _, metrics = self._chunk(0, chan, metrics)
            return word.movedim(0, -1).contiguous(), metrics
        ident = torch.arange(n_list, device=flat.device).expand(n_batch, n_list)
        llrs = [None] * n_outer  # stage s: [B, L, N >> s] in cdt
        bits = [None] * n_outer  # stage s: packed [B, N >> s] or [B, W, N >> s]
        lag_l = [ident] * n_outer  # current slots -> the slots a buffer is stored in
        lag_b = [ident] * n_outer
        segs, perms = [], []
        for t in range(self.n_chunks):
            prev = chan
            for s in range(1, n_outer + 1):
                if t % (1 << (n_outer - s)) == 0:
                    span = n_len >> s
                    if (t >> (n_outer - s)) & 1:  # g, reading the parent through its lag
                        par = chan if s == 1 else _take_paths(llrs[s - 2], lag_l[s - 2])
                        par = par.to(torch.float32)
                        left = _planes(bits[s - 1], lag_b[s - 1], words).to(torch.float32)
                        cur = g_fn(par[..., :span], par[..., span:], 1.0 - 2.0 * left)
                    else:  # f: the parent was refreshed at this step
                        work = prev.to(torch.float32)
                        cur = f_fn(work[..., :span], work[..., span:])
                    llrs[s - 1] = cur.to(cdt)
                    lag_l[s - 1] = ident
                prev = llrs[s - 1]
            word, perm, metrics = self._chunk(t, prev.to(torch.float32), metrics)
            lags = _compose(torch.stack(lag_l + lag_b), perm)  # one gather for all
            lag_l, lag_b = list(lags[:n_outer]), list(lags[n_outer:])
            segs.append(word)
            perms.append(perm)
            climb = min(_trailing_ones(t), n_outer)
            for c in range(climb):
                s = n_outer - c
                word = torch.cat([_take_word(bits[s - 1], lag_b[s - 1], words) ^ word, word],
                                 dim=-1)
            if climb < n_outer:
                bits[n_outer - climb - 1] = word
                lag_b[n_outer - climb - 1] = ident
        return self._join_chunks(segs, perms).movedim(0, -1).contiguous(), metrics

    # ---- the tree schedule ---------------------------------------------

    def _tree_node(self, node: CodeNode, llr: torch.Tensor, metrics: torch.Tensor):
        """llr [B, L, span] f32 -> (word [B, span] i32, or [B, W, span];
        perm [B, L] i64; metrics [B, L]): a leaf through K1, a mixed chunk
        through K7, a longer branch node by f, g and its children."""
        if node.kind != NodeKind.BRANCH:
            return self._leaf(self._tree_scheds[node], llr, metrics)
        if node.length == self.chunk:
            t = node.offset // self.chunk
            sub = None if self._subs_t is None else self._subs_t[t]
            word, perm, metrics = self.chunk_fn(llr.contiguous(), self._masks_t[t], metrics,
                                                sub, family=self.family)
            return word, perm.to(torch.int64), metrics
        f_fn, g_fn = self._fg
        half = node.length // 2
        a, b = llr[..., :half], llr[..., half:]
        left, p_left, metrics = self._tree_node(node.left, f_fn(a, b), metrics)
        llr_g = _take_paths(llr, p_left)
        lanes = torch.arange(self.list_size, device=left.device).expand_as(p_left)
        left_bip = 1.0 - 2.0 * _planes(left, lanes, self.words).to(torch.float32)
        right, p_right, metrics = self._tree_node(
            node.right, g_fn(llr_g[..., :half], llr_g[..., half:], left_bip), metrics)
        left = _take_word(left, p_right, self.words)
        return torch.cat([left ^ right, right], dim=-1), _compose(p_left, p_right), metrics

    def _join_chunks(self, segs, perms) -> torch.Tensor:
        """Chunk segments (packed [B, M] or [B, W, M] words, each in the slot
        order of its step) and chunk perms -> the packed codeword word [B, N]
        or [B, W, N]: map the final slots back through the later chunk
        perms, gather each segment once, and apply the top log2(T)
        butterfly stages."""
        n_batch = segs[0].shape[0]
        backs = [torch.arange(self.list_size, device=segs[0].device).expand(
            n_batch, self.list_size)]
        for t in range(self.n_chunks - 1, 0, -1):
            backs.append(_compose(perms[t], backs[-1]))
        x = _take_word(torch.stack(segs, dim=1), torch.stack(backs[::-1], dim=1),
                       self.words)  # [B, T, M] or [B, T, W, M]
        x = x.movedim(1, -2)  # [..., T, M]
        lead = x.shape[:-2]
        stride = 1
        while stride < self.n_chunks:
            x = x.reshape(lead + (self.n_chunks // (2 * stride), 2, stride, self.chunk))
            x = torch.stack([x[..., 0, :, :] ^ x[..., 1, :, :], x[..., 1, :, :]], dim=-3)
            stride *= 2
        return x.reshape(lead + (self.block_length,))
