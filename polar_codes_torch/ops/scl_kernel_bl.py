"""SCL subtree kernel K1 (csrc/scl_subtree.cu), its plain version, and the
schedule that carries a subtree to the kernel as data.

Counterpart of polar_codes_tpu/ops/scl_kernel_bl.py: one call decodes a
whole span <= kernel_span subtree for a batch of codewords, in the TPU
kernel's batch-minor layouts,

    (llr [w_in, span, B], metrics [B, w_in] f32)
        -> (bits [span, B] i32, perm [B, w_out] i32, metrics [B, w_out] f32)

with bit l of a bits word holding path l's decision (the bitplane form)
and perm mapping each output slot to the input slot it descends from. A
list of more than 32 paths packs its bits into W = ceil(L / 32) words,
bits [W, span, B] (path l: bit l % 32 of word l // 32), the port's
counterpart of the TPU kernel's unpacked-path family (bitplane=False),
which it takes for L > 32. The TPU kernel is traced per subtree; here
`build_schedule` flattens the subtree once on the host into a post-order
op list (F, G, COMBINE, LEAF), and the CUDA kernels run any schedule at any
list size as data. Two sources: csrc/scl_subtree.cu keeps one codeword's
list state in shared memory, a warp a codeword, one kernel per family and
power-of-two list capacity up to MAX_LIST (the list size a launch
argument: slots at or above it never become live; L = 2, 4, 8, 16, 32
each have a kernel with the list size fixed at build time); csrc/
scl_wide.cu takes every schedule that one does not (L > MAX_LIST, or a
branched span whose state exceeds the card's shared memory), a block a
codeword with the LLR levels in a device-memory scratch.

Three arithmetic families, chosen by the dtype of the LLR state (the
three branches of the JAX _BlEmitter):
  float32   f on the raw bits, g = b +- a, decisions by the sign bit;
  char      int16 state holding the int8 decoder's integer LLRs (the TPU
            kernel holds them in bf16): f in product form, unclipped, so an
            input of -128 gives |f| = 128; g clipped to [-127, 127];
            decisions llr < 0, so 0 decides bit 0;
  bfloat16  bf16 state: f and g computed in float32 and rounded once on
            store; decisions by the sign bit.
Leaves read the state as float32 in every family, and metric sums
accumulate in float32.

`scl_subtree` runs `scl_subtree_plain` for tensors on the CPU and the CUDA
kernel for tensors on the card, never one in place of the other.
`scl_subtree_plain` is _BlEmitter's bitplane path in torch ops on
[w, S, B] tensors: it walks the node tree itself and does not read the op
list, so the two versions check each other. Its sums run sequentially over
the span, in the kernel's order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .fg import f_minsum, f_minsum_bits, f_minsum_sat, g_update, g_update_sat
from ..models.tree import CodeNode, NodeKind

MAX_LIST = 128  # scl_subtree.cu's largest list (4 words); scl_wide.cu takes any L
MAX_CAND = 32  # candidate slots per path in the kernel (ENUM k <= 5)
MAX_LEVELS = 16  # tree levels per subtree in the kernel
# kernel launches per family since the counts were last reset, and per
# list size (every family; cleared by the caller)
LAUNCHES = {"float32": 0, "char": 0, "bfloat16": 0}
LIST_LAUNCHES: Dict[int, int] = {}
# of LAUNCHES, those of the device-memory kernel (csrc/scl_wide.cu), per family
WIDE_LAUNCHES = {"float32": 0, "char": 0, "bfloat16": 0}
# codewords (warps) per block of a K1 launch: 1, 2 or 4; 0 lets the kernel
# choose from the batch
PER_BLOCK = 0

OP_F, OP_G, OP_COMBINE, OP_LEAF = 0, 1, 2, 3
_KIND_CODE = {
    NodeKind.RATE0: 0, NodeKind.RATE1: 1, NodeKind.REP: 2,
    NodeKind.SPC: 3, NodeKind.ENUM: 4,
}

# SPC flip tables [candidate, weak index] for even/odd parity, whether a
# candidate pays -m0 under even parity, and which of m1..m3 it pays
# (the reference's 8-candidate construction; models/scl.py in both packages).
SPC_FLIPS_EVEN = np.array(
    [[0, 0, 0, 0], [1, 1, 0, 0], [1, 0, 1, 0], [1, 0, 0, 1],
     [0, 1, 1, 0], [0, 1, 0, 1], [0, 0, 1, 1], [1, 1, 1, 1]], dtype=bool)
SPC_FLIPS_ODD = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
     [1, 1, 1, 0], [1, 1, 0, 1], [1, 0, 1, 1], [0, 1, 1, 1]], dtype=bool)
SPC_M0_EVEN = np.array([0, 1, 1, 1, 0, 0, 0, 1], dtype=np.float32)
SPC_T = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
     [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.float32)


def _bitmask(rows: np.ndarray) -> np.ndarray:
    """[R, K] {0,1} -> [R] int32 with bit k = rows[:, k]."""
    return (rows.astype(np.int64) << np.arange(rows.shape[1])).sum(1).astype(np.int32)


# [even flips | odd flips | m0_even | T], one int per candidate
SPC_TABLE = np.concatenate([
    _bitmask(SPC_FLIPS_EVEN), _bitmask(SPC_FLIPS_ODD),
    SPC_M0_EVEN.astype(np.int32), _bitmask(SPC_T),
]).astype(np.int32)


def enum_table(node: CodeNode) -> np.ndarray:
    """[2^k, span] bipolar codewords of an ENUM leaf's subcode, in the JAX
    package's candidate order (SCLDecoder._enum_table)."""
    span, frozen = node.length, node.frozen
    info = np.setdiff1d(np.arange(span), frozen)
    k = info.size
    u = np.zeros((1 << k, span), dtype=np.uint8)
    u[:, info] = (np.arange(1 << k)[:, None] >> np.arange(k - 1, -1, -1)) & 1
    x = u.copy()
    s = 1
    while s < span:
        for i in range(0, span, 2 * s):
            x[:, i : i + s] ^= x[:, i + s : i + 2 * s]
        s *= 2
    return (1.0 - 2.0 * x).astype(np.float32)


def n_candidates(node: CodeNode) -> int:
    """Candidates per path at a forking leaf (0 for RATE0, which keeps w)."""
    if node.kind == NodeKind.RATE0:
        return 0
    if node.kind == NodeKind.RATE1:
        return 2 if node.length == 1 else 4
    if node.kind == NodeKind.REP:
        return 2
    if node.kind == NodeKind.SPC:
        return 8
    return 1 << node.info_count


def static_width(node: CodeNode, w: int, list_size: int) -> int:
    """List width after the subtree: each fork multiplies the width by its
    candidate count, clamped at L (scl_kernel_bl.py _static_width)."""
    if node.kind == NodeKind.BRANCH:
        return static_width(node.right, static_width(node.left, w, list_size),
                            list_size)
    n_cand = n_candidates(node)
    return w if n_cand == 0 else min(w * n_cand, list_size)


@dataclass(eq=False)
class SubtreeSchedule:
    """One subtree, flattened for the kernel: `ops` [n_ops, 8] int32 rows
    {op, level, length, offset, kind, aux, ncand, 0} in post-order, and the
    ENUM leaves' codeword bitmasks (candidate c of the leaf at aux is
    enum_masks[aux + c]; bit s set where the codeword has a 1)."""

    node: CodeNode
    w_in: int
    w_out: int
    list_size: int
    ops: np.ndarray
    levels: int
    enum_masks: np.ndarray
    _device_consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, repr=False)

    @property
    def span(self) -> int:
        return self.node.length

    def device_consts(self, device: torch.device):
        """(ops, enum masks, SPC table) as int32 tensors on `device`."""
        consts = self._device_consts.get(device)
        if consts is None:
            masks = self.enum_masks if self.enum_masks.size else np.zeros(1, np.int32)
            consts = tuple(torch.as_tensor(a, device=device)
                           for a in (self.ops, masks, SPC_TABLE))
            self._device_consts[device] = consts
        return consts


def build_schedule(node: CodeNode, w_in: int, list_size: int) -> SubtreeSchedule:
    """Flatten the subtree rooted at `node` (entered at width w_in)."""
    ops, masks = [], []
    root = node.offset
    depth = [0]

    def emit(n: CodeNode, level: int):
        depth[0] = max(depth[0], level + 1)
        off = n.offset - root
        if n.kind != NodeKind.BRANCH:
            aux = 0
            if n.kind == NodeKind.ENUM:
                if n.length > 32:
                    raise NotImplementedError("ENUM leaves longer than 32")
                aux = len(masks)
                masks.extend(_bitmask(enum_table(n) < 0))
            n_cand = n_candidates(n)
            if n_cand > MAX_CAND:
                raise NotImplementedError(
                    f"a leaf with {n_cand} candidates (kernel limit {MAX_CAND})")
            ops.append([OP_LEAF, level, n.length, off, _KIND_CODE[n.kind], aux,
                        n_cand, 0])
            return
        ops.append([OP_F, level, n.length, off, 0, 0, 0, 0])
        emit(n.left, level + 1)
        ops.append([OP_G, level, n.length, off, 0, 0, 0, 0])
        emit(n.right, level + 1)
        ops.append([OP_COMBINE, level, n.length, off, 0, 0, 0, 0])

    emit(node, 0)
    return SubtreeSchedule(
        node=node, w_in=w_in, w_out=static_width(node, w_in, list_size),
        list_size=list_size, ops=np.asarray(ops, np.int32).reshape(-1, 8),
        levels=depth[0], enum_masks=np.asarray(masks, np.int32),
    )


# ---- packed-word helpers (shared by the plain version and the glue) --------
#
# A list of L paths packs its decision bits into n_words(L) int32 words per
# (position, codeword): path l is bit l % 32 of word l // 32. One word (L <=
# 32) is an [S, B] tensor; more are [W, S, B], the word axis first. Each
# helper takes the word count (`words`, default 1, the single-word form).

def n_words(list_size: int) -> int:
    """int32 words a packed position holds for `list_size` paths."""
    return max(1, (list_size + 31) // 32)


def pack_planes(bits: torch.Tensor, words: int) -> torch.Tensor:
    """[w, ...] int {0,1}, w <= 32 * words -> [words, ...] int32: plane l
    into bit l % 32 of word l // 32, 32 planes a word in one sum."""
    pad = 32 * words - bits.shape[0]
    bits = bits.to(torch.int32)
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad,) + bits.shape[1:])])
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    shifts = shifts.view((1, 32) + (1,) * (bits.dim() - 1))
    # bit 31 shifts to -2^31, so each sum lies in the int32 range
    return (bits.reshape((words, 32) + bits.shape[1:]) << shifts).sum(1).to(torch.int32)


def pack01(b01: torch.Tensor, words: int = 1) -> torch.Tensor:
    """[w, ...] int {0,1} -> packed [...] int32 (plane l = row l), or
    [words, ...] for more than one word."""
    packed = pack_planes(b01, words)
    return packed[0] if words == 1 else packed


def plane(word: torch.Tensor, l, words: int = 1) -> torch.Tensor:
    """Path l's {0,1} bits [S, B] of a packed word; l is an int or a [B]
    tensor of paths per codeword."""
    if words == 1:
        return (word >> (l[None, :] if torch.is_tensor(l) else l)) & 1
    if not torch.is_tensor(l):
        return (word[l >> 5] >> (l & 31)) & 1
    sel = torch.gather(word, 0, (l >> 5)[None, None, :].expand(1, word.shape[1], -1))[0]
    return (sel >> (l & 31)[None, :]) & 1


def take_packed(word: torch.Tensor, src: torch.Tensor, w_out: int,
                words: int = 1) -> torch.Tensor:
    """Path-fork gather on a packed word: out plane l = in plane src[l, b];
    src is [w_out, B]. Every plane is gathered at once: its word by
    src >> 5 (above one word) and its bit by src & 31."""
    if words == 1:
        planes = (word[None] >> src[:w_out, None, :].to(torch.int32)) & 1
        return pack_planes(planes, 1)[0]
    src = src.to(torch.int64)
    sel = torch.gather(word, 0, (src >> 5)[:, None, :].expand(-1, word.shape[1], -1))
    return pack_planes((sel >> (src & 31).to(torch.int32)[:, None, :]) & 1, words)


def unpack(word: torch.Tensor, w: int, words: int = 1) -> torch.Tensor:
    """Packed word -> [w, S, B] int32 {0,1} planes."""
    lanes = torch.arange(w, device=word.device)
    shifts = (lanes & 31).to(torch.int32).view((w,) + (1,) * (word.dim() - (words > 1)))
    return ((word[None] if words == 1 else word[lanes >> 5]) >> shifts) & 1


def packed_bipolar(word: torch.Tensor, w: int, words: int = 1) -> torch.Tensor:
    """Packed word -> [w, S, B] bipolar +-1 float32 (g's operand)."""
    return (1 - 2 * unpack(word, w, words)).to(torch.float32)


def take_state(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """[w_in, S, B] gathered along the path axis by src [w_out, B]."""
    idx = src.to(torch.int64)[:, None, :].expand(src.shape[0], x.shape[1], x.shape[2])
    return torch.gather(x, 0, idx)


def take_vec(v: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """[w_in, B] per-path values gathered by src [w_out, B]."""
    return torch.gather(v, 0, src.to(torch.int64))


# ---- the arithmetic families -----------------------------------------------

class _Float:
    name, code = "float32", 0
    f = staticmethod(f_minsum_bits)
    g = staticmethod(g_update)
    hard = staticmethod(torch.signbit)


class _Char:
    name, code = "char", 1
    f = staticmethod(f_minsum_sat)
    g = staticmethod(g_update_sat)

    @staticmethod
    def hard(x):
        return x < 0


class _Bf16:
    name, code = "bfloat16", 2
    hard = staticmethod(torch.signbit)

    @staticmethod
    def f(a, b):
        return f_minsum(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)

    @staticmethod
    def g(a, b, left_bipolar):
        return g_update(a, b, left_bipolar.to(a.dtype))


FAMILIES = {torch.float32: _Float, torch.int16: _Char, torch.bfloat16: _Bf16}


def family(dtype: torch.dtype):
    """The arithmetic family of an LLR state dtype (float32, int16 for the
    char family, bfloat16)."""
    fam = FAMILIES.get(dtype)
    if fam is None:
        raise ValueError(f"K1 takes float32, int16 (char) or bfloat16 LLRs, got {dtype}")
    return fam


# ---- the plain version -----------------------------------------------------

def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of [w, S, B] over S, one add at a time from 0, in f32 (the
    kernel's order)."""
    acc = torch.zeros_like(x[:, 0])
    for s in range(x.shape[1]):
        acc = acc + x[:, s]
    return acc


class _Plain:
    """_BlEmitter's bitplane path on [w, S, B] tensors, in the arithmetic
    family `fam`. Perms are [w, B] int64 tensors, or None for the identity.

    `drop` is the value a prune round leaves on the candidate it took:
    -inf takes every candidate once (K1, where no candidate sits at the
    inactive-slot metric); the masked-SCL chunk kernel K7 keeps the TPU
    kernel's _NEG, so once only values <= _NEG remain a taken candidate
    can be taken again (ops/large_kernel.py)."""

    def __init__(self, list_size: int, drop: float = float("-inf"), fam=_Float):
        self.n_list = list_size
        self.words = n_words(list_size)
        self.drop = drop
        self.fam = fam

    def prune(self, metrics, deltas):
        """metrics [w, B], deltas [C, w, B] -> (metrics' [w', B],
        src [w', B], cand [w', B]), ordered by (value desc, code l*C + c
        asc); every candidate survives, in l-major slots, while w*C <= L."""
        n_cand, width = deltas.shape[0], metrics.shape[0]
        total = width * n_cand
        flat = (metrics[None] + deltas).permute(1, 0, 2).reshape(total, -1)
        codes = torch.arange(total, device=flat.device)[:, None]
        if total <= self.n_list:
            idx = codes.expand_as(flat)
            return flat, idx // n_cand, idx % n_cand
        cur = flat
        vals, idxs = [], []
        for _ in range(self.n_list):
            v = cur.max(dim=0).values
            i = torch.where(cur == v[None], codes, total).min(dim=0).values
            vals.append(v)
            idxs.append(i)
            cur = torch.where(codes == i[None], self.drop, cur)
        idx = torch.stack(idxs, 0)
        return torch.stack(vals, 0), idx // n_cand, idx % n_cand

    @staticmethod
    def weakest(mag, count):
        """`count` smallest values of [w, S, B] over S, first index on ties."""
        span = mag.shape[1]
        iota = torch.arange(span, device=mag.device)[None, :, None]
        cur = mag
        ms, idxs = [], []
        for _ in range(count):
            m = cur.min(dim=1).values
            i = torch.where(cur == m[:, None], iota, span).min(dim=1).values
            ms.append(m)
            idxs.append(i)
            cur = torch.where(iota == i[:, None], float("inf"), cur)
        return ms, idxs

    def leaf(self, node: CodeNode, llr, metrics):
        llr = llr.to(torch.float32)  # leaves compute in float32 in every family
        span = llr.shape[1]
        hard = self.fam.hard(llr).to(torch.int32)
        pos = torch.arange(span, device=llr.device)[None, :, None]
        if node.kind == NodeKind.RATE0:
            shape = llr.shape[1:] if self.words == 1 else (self.words,) + llr.shape[1:]
            zeros = torch.zeros(shape, dtype=torch.int32, device=llr.device)
            return zeros, None, metrics + _seq_sum(torch.clamp(llr, max=0.0))
        if node.kind == NodeKind.REP:
            deltas = torch.stack([_seq_sum(torch.clamp(llr, max=0.0)),
                                  -_seq_sum(torch.clamp(llr, min=0.0))])
            new_m, src, cand = self.prune(metrics, deltas)
            word = pack01((cand != 0).to(torch.int32), self.words)  # [B] or [W, B]
            return (word.unsqueeze(-2).expand(*word.shape[:-1], span, -1).contiguous(), src,
                    new_m)
        if node.kind == NodeKind.ENUM:
            table = torch.as_tensor(enum_table(node), device=llr.device)
            sum_abs = _seq_sum(llr.abs())
            scores = torch.zeros((table.shape[0],) + sum_abs.shape,
                                 device=llr.device)
            for s in range(span):  # +-x exactly, added in span order
                scores = scores + table[:, s, None, None] * llr[None, :, s]
            new_m, src, cand = self.prune(metrics, 0.5 * (scores - sum_abs[None]))
            neg = (table < 0).to(torch.int32)[cand]  # [w', B, S]
            return pack01(neg.permute(0, 2, 1), self.words), src, new_m
        mag = llr.abs()
        if node.kind == NodeKind.RATE1 and span == 1:
            m0 = mag[:, 0]
            new_m, src, cand = self.prune(
                metrics, torch.stack([torch.zeros_like(m0), -m0]))
            bits = take_state(hard, src) ^ (cand == 1).to(torch.int32)[:, None]
            return pack01(bits, self.words), src, new_m
        if node.kind == NodeKind.RATE1:
            (m0, m1), (i0, i1) = self.weakest(mag, 2)
            deltas = torch.stack([torch.zeros_like(m0), -m0, -m1, -m0 - m1])
            new_m, src, cand = self.prune(metrics, deltas)
            flip0 = ((cand == 1) | (cand == 3))[:, None] & (pos == take_vec(i0, src)[:, None])
            flip1 = ((cand == 2) | (cand == 3))[:, None] & (pos == take_vec(i1, src)[:, None])
            bits = take_state(hard, src) ^ (flip0 | flip1).to(torch.int32)
            return pack01(bits, self.words), src, new_m
        # SPC
        ms, idxs = self.weakest(mag, 4)
        parity_odd = hard.sum(dim=1) % 2 == 1
        m0 = ms[0]
        deltas = []
        for c in range(8):
            t_cost = torch.zeros_like(m0)
            for j in range(3):
                if SPC_T[c, j]:
                    t_cost = t_cost + ms[1 + j]
            d_even = -float(SPC_M0_EVEN[c]) * m0 - t_cost
            d_odd = -m0 - t_cost
            deltas.append(torch.where(parity_odd, d_odd, d_even))
        new_m, src, cand = self.prune(metrics, torch.stack(deltas))
        po = take_vec(parity_odd.to(torch.int64), src) == 1
        even = torch.as_tensor(SPC_FLIPS_EVEN, device=llr.device)[cand]  # [w', B, 4]
        odd = torch.as_tensor(SPC_FLIPS_ODD, device=llr.device)[cand]
        flips = torch.where(po[..., None], odd, even)
        flip = torch.zeros_like(take_state(hard, src), dtype=torch.bool)
        for j in range(4):
            flip = flip | (flips[..., j][:, None] & (pos == take_vec(idxs[j], src)[:, None]))
        return pack01(take_state(hard, src) ^ flip.to(torch.int32), self.words), src, new_m

    def node(self, node: CodeNode, llr, metrics):
        """llr [w, S, B], metrics [w, B] -> (packed word [S, B] or [W, S, B],
        perm, metrics)."""
        if node.kind != NodeKind.BRANCH:
            return self.leaf(node, llr, metrics)
        half = node.length // 2
        a, b = llr[:, :half], llr[:, half:]
        left, p_left, metrics = self.node(node.left, self.fam.f(a, b), metrics)
        w_mid = metrics.shape[0]
        if p_left is not None:
            llr_g = take_state(llr, p_left)
            a, b = llr_g[:, :half], llr_g[:, half:]
        right, p_right, metrics = self.node(
            node.right, self.fam.g(a, b, packed_bipolar(left, w_mid, self.words)), metrics)
        if p_right is not None:
            left = take_packed(left, p_right, metrics.shape[0], self.words)
        perm = p_right if p_left is None else (
            p_left if p_right is None else take_vec(p_left, p_right))
        return torch.cat([left ^ right, right], dim=-2), perm, metrics


def scl_subtree_plain(sched: SubtreeSchedule, llr: torch.Tensor,
                      metrics: torch.Tensor):
    """Plain version of K1, on any device: (llr [w_in, span, B] float32,
    int16 or bfloat16, which picks the family; metrics [B, w_in] f32) ->
    (bits [span, B] i32, or [W, span, B] for L > 32; perm [B, w_out] i32;
    metrics [B, w_out] f32)."""
    plain = _Plain(sched.list_size, fam=family(llr.dtype))
    word, perm, met = plain.node(sched.node, llr, metrics.T)
    if perm is None:
        perm = torch.arange(met.shape[0], device=llr.device)[:, None].expand_as(met)
    return (word.to(torch.int32).contiguous(), perm.T.to(torch.int32).contiguous(),
            met.T.contiguous())


def _bind(lib):
    fn = lib.scl_subtree
    if fn.argtypes is None:  # first use of this library
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.scl_subtree_smem.argtypes = [ctypes.c_int] * 4
        lib.scl_subtree_smem.restype = ctypes.c_int
        lib.scl_subtree_smem_limit.argtypes = []
        lib.scl_subtree_smem_limit.restype = ctypes.c_int
    return fn


# shared_bytes of the wrapper's library by (L, span, family code, n_ops,
# device): what a decode's calls ask again and again
_SHARED_BYTES: Dict[Tuple[int, int, int, int, Optional[int]], int] = {}


def shared_bytes(lib, sched: SubtreeSchedule, fam) -> int:
    """Shared-memory bytes per codeword of `sched` in family `fam` in the
    kernel that keeps the list state in shared memory (`lib`, the build of
    csrc/scl_subtree.cu) on the current card, or -1 where that kernel does
    not take the schedule: L > MAX_LIST, or a branched schedule whose state
    exceeds the card's opt-in shared memory per block (a one-leaf schedule
    that does not fit staged reads its input from device memory and needs
    no level state). scl_subtree sends those to csrc/scl_wide.cu."""
    _bind(lib)
    need = lib.scl_subtree_smem(sched.list_size, sched.span, fam.code, sched.ops.shape[0])
    return need if 0 <= need <= lib.scl_subtree_smem_limit() else -1


def scl_subtree(sched: SubtreeSchedule, llr: torch.Tensor, metrics: torch.Tensor):
    """K1: the plain version for CPU tensors, a CUDA kernel of the LLRs'
    family for CUDA tensors (same signature as scl_subtree_plain), at any
    list size L >= 1 and any span.

    Where one codeword's list state fits the card's shared memory
    (shared_bytes), one warp decodes one codeword with that state (the LLRs
    of every tree level below the subtree's root, the packed bit words,
    the perms) in shared memory, PER_BLOCK codewords a block (0: chosen
    from the batch), in the instantiation of the next power of two up to
    MAX_LIST (L = 1 in a one-path instantiation: the large-N decoders'
    one-leaf schedules at one path; SCLDecoder decodes L = 1 through
    Fast-SSC); a one-leaf schedule whose input does not fit there as well
    is decoded from device memory. Every other schedule (L > MAX_LIST, or
    a branched span whose L * span values of state exceed shared memory) runs in
    csrc/scl_wide.cu: a block a codeword, the levels in a device-memory
    scratch, the bookkeeping in shared memory (launch_wide), reading llr at
    its own strides (the large-N glue's leaves are views of batch-first
    [B, L, S] tensors, each codeword's paths side by side), as the
    shared-memory kernel does too. A scratch larger than the card's memory
    raises MemoryError."""
    if llr.device.type == "cpu":
        return scl_subtree_plain(sched, llr, metrics)
    if llr.device.type != "cuda" or metrics.device != llr.device:
        raise ValueError(
            f"scl_subtree takes CPU or CUDA tensors on one device, got "
            f"{llr.device} and {metrics.device}")
    n_batch = llr.shape[-1]
    fam = FAMILIES.get(llr.dtype)
    if fam is None or metrics.dtype != torch.float32:
        raise ValueError("scl_subtree takes float32, int16 (char) or bfloat16 LLRs "
                         f"and float32 metrics, got {llr.dtype} and {metrics.dtype}")
    if llr.shape != (sched.w_in, sched.span, n_batch) or metrics.shape != (n_batch, sched.w_in):
        raise ValueError(
            f"scl_subtree expects llr [{sched.w_in}, {sched.span}, B] and metrics "
            f"[B, {sched.w_in}], got {tuple(llr.shape)} and {tuple(metrics.shape)}")
    if not metrics.is_contiguous():
        raise ValueError("scl_subtree takes contiguous metrics")
    if sched.list_size < 1 or sched.levels > MAX_LEVELS:
        raise NotImplementedError(
            f"the kernels cover L >= 1 and at most {MAX_LEVELS} tree levels, got "
            f"L={sched.list_size}, {sched.levels} levels")
    lib = _build.load("scl_subtree")
    key = (sched.list_size, sched.span, fam.code, sched.ops.shape[0], llr.device.index)
    need = _SHARED_BYTES.get(key)
    if need is None:
        need = _SHARED_BYTES[key] = shared_bytes(lib, sched, fam)
    if need < 0:
        out = launch_wide(_build.load("scl_wide"), sched, llr, metrics)
        WIDE_LAUNCHES[fam.name] += 1
    else:
        out = launch(lib, sched, llr, metrics)
    LAUNCHES[fam.name] += 1
    LIST_LAUNCHES[sched.list_size] = LIST_LAUNCHES.get(sched.list_size, 0) + 1
    return out


def launch(lib, sched: SubtreeSchedule, llr: torch.Tensor, metrics: torch.Tensor):
    """Launch K1 from the loaded library `lib` on checked CUDA tensors; llr
    [w_in, span, B] at any strides (read in place)."""
    fn = _bind(lib)
    fam = FAMILIES[llr.dtype]
    dev = llr.device
    ops, masks, spc = sched.device_consts(dev)
    n_batch = llr.shape[-1]
    words = n_words(sched.list_size)
    shape = (sched.span, n_batch) if words == 1 else (words, sched.span, n_batch)
    bits = torch.empty(shape, dtype=torch.int32, device=dev)
    perm = torch.empty((n_batch, sched.w_out), dtype=torch.int32, device=dev)
    met = torch.empty((n_batch, sched.w_out), dtype=torch.float32, device=dev)
    err = fn(ops.data_ptr(), ops.shape[0], masks.data_ptr(), spc.data_ptr(),
             llr.data_ptr(), *llr.stride(), metrics.data_ptr(), bits.data_ptr(),
             perm.data_ptr(), met.data_ptr(), sched.list_size, sched.w_in, sched.w_out,
             sched.span, n_batch, fam.code, PER_BLOCK, _stream_of(dev))
    if err:
        raise RuntimeError(f"scl_subtree launch failed: CUDA error {err}")
    return bits, perm, met


# ---- the device-memory kernel (csrc/scl_wide.cu), K1's and K7's -------------

WIDE_FAMILY_CODES = {"float32": 0, "char": 1, "bfloat16": 2, "chunk_char": 3}


def _bind_wide(lib):
    fn = lib.scl_subtree_wide
    if fn.argtypes is None:  # first use of this library
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        chunk = lib.masked_scl_chunk_wide
        chunk.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                          + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                          + [ctypes.c_void_p])
        chunk.restype = ctypes.c_int
        lib.scl_wide_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.scl_wide_plan.restype = ctypes.c_int
    return fn


def wide_plan(lib, list_size: int, span: int, levels: int, ncand: int,
              family_code: int) -> Tuple[int, int]:
    """(shared-memory bytes, device scratch bytes) per codeword of the
    device-memory kernel on a schedule of `levels` levels at `span` with at
    most `ncand` candidates a path; family codes in WIDE_FAMILY_CODES."""
    _bind_wide(lib)
    out = (ctypes.c_longlong * 2)()
    if lib.scl_wide_plan(list_size, span, levels, ncand, family_code, out) != 0:
        raise ValueError(f"no device-memory plan for L={list_size}, span {span}, "
                         f"{levels} levels, {ncand} candidates")
    return int(out[0]), int(out[1])


def wide_scratch(lib, dev: torch.device, n_batch: int, list_size: int, span: int,
                 levels: int, ncand: int, family_code: int, what: str) -> torch.Tensor:
    """The device-memory kernel's scratch for a batch, from PyTorch's
    caching allocator on `dev`; MemoryError where it exceeds the card's
    memory."""
    need = n_batch * wide_plan(lib, list_size, span, levels, ncand, family_code)[1]
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        if need > total:
            raise MemoryError(
                f"{what}: L={list_size}, span {span}, B={n_batch} keeps {need} bytes of list "
                f"state in device memory; the card has {total}")
    return torch.empty(max(need, 1), dtype=torch.uint8, device=dev)


def _stream_of(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None


def launch_wide(lib, sched: SubtreeSchedule, llr: torch.Tensor, metrics: torch.Tensor):
    """Launch K1's device-memory kernel from the loaded library `lib` (the
    build of csrc/scl_wide.cu, or its CPU build) on checked tensors; llr
    [w_in, span, B] at any strides."""
    fn = _bind_wide(lib)
    fam = FAMILIES[llr.dtype]
    dev = llr.device
    ops, masks, spc = sched.device_consts(dev)
    n_batch = llr.shape[-1]
    words = n_words(sched.list_size)
    ncand = max(1, int(sched.ops[:, 6].max()))
    scratch = wide_scratch(lib, dev, n_batch, sched.list_size, sched.span, sched.levels,
                           ncand, fam.code, "scl_subtree")
    shape = (sched.span, n_batch) if words == 1 else (words, sched.span, n_batch)
    bits = torch.empty(shape, dtype=torch.int32, device=dev)
    perm = torch.empty((n_batch, sched.w_out), dtype=torch.int32, device=dev)
    met = torch.empty((n_batch, sched.w_out), dtype=torch.float32, device=dev)
    err = fn(ops.data_ptr(), ops.shape[0], masks.data_ptr(), spc.data_ptr(),
             llr.data_ptr(), *llr.stride(), metrics.data_ptr(), bits.data_ptr(),
             perm.data_ptr(), met.data_ptr(), scratch.data_ptr(), sched.list_size,
             sched.w_in, sched.w_out, sched.span, sched.levels, ncand, n_batch, fam.code,
             _stream_of(dev))
    if err:
        raise RuntimeError(f"scl_subtree (device-memory kernel) launch failed: CUDA error {err}")
    return bits, perm, met
