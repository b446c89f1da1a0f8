"""Masked chunk kernels of the large-N decoders: K6 (csrc/large_sc_chunk.cu)
and K7 (csrc/large_scl_chunk.cu, csrc/large_scl_lists.cu), each beside its
plain version.

Counterpart of polar_codes_tpu/ops/large_kernel.py. The large-N decoders
(models/large.py) cut the code tree at the chunk span M and decode every
mixed chunk with one generic recursion whose frozen mask arrives as data,
so one kernel serves every chunk of every code:

    K6  masked SC:   (llr [B, M] f32, mask [M] u8)
                         -> (x [B, M], u [B, M]) bipolar f32
    K7  masked SCL:  (llr [B, L, M] f32, mask [M] u8, metrics [B, L] f32
                      [, sub_cls [M / sub] i32])
                         -> (bits [B, M] i32, or [B, W, M] for L > 32,
                             perm [B, L] i32, metrics [B, L] f32)

each in two families, named by `family` (the TPU kernels' int8 flag):
"float32", and "char", the int8 decoders' integer-valued LLRs in the same
float32 interface, with g clipped to [-127, 127] (g_update_sat) and hard
decisions llr < 0, so 0 decides bit 0. f is never clipped: an input of
-128 gives |f| = 128, which float32 holds.

K6 is plain SC with the product-form f (ops/fg.py f_minsum, which keeps
the JAX package's signed zeros) and a hard decision at each span-1 leaf
(float32: the sign bit, so -0.0 decides 1), frozen leaves forced to 0. x is
the chunk's codeword segment, u its leaf decisions.

K7 is bitwise SCL: every span-1 leaf forks each path into {keep, flip}
with deltas {0, -|llr|} (a frozen leaf: {min(llr, 0), _NEG}, so the flip
never survives) and one uniform 2-candidate prune keeps L paths. Inside the
chunk f is the sign-XOR form (f_minsum_bits), as in the TPU kernel. With
sub_cls (one class code per sub-block of span sub = M / len(sub_cls), the
codes of models/large.py _classify_chunks) the recursion stops at span sub
and a pure sub-block takes the SSCL leaf rule of its class (rate0, rate1
with 4 candidates, rep, spc with 8); a mixed one goes on bit by bit. The
decision bits leave packed, one int32 word per (codeword, position) with
bit l = path l (the word K1 and the SCL glue use, batch-first here because
the large-N glue is); above 32 paths W = ceil(L / 32) words per position,
[B, W, M], path l in bit l % 32 of word l // 32 (K1's words, ahead of the
positions). perm maps each output slot to the input slot it descends
from. K7 takes any L >= 1 at any chunk: where one codeword's state fits
shared memory, L = 2, 4, 8, 16, 32 in kernels of their own size (library
large_scl_chunk), every other L in the kernel of its capacity (4, 32, 64
or 128) with the list size at run time (library large_scl_lists: a warp a
codeword up to 32 paths, a block of 2 x capacity threads above;
`scl_library` picks); every other (L, chunk) in csrc/scl_wide.cu, a block
of 1024 threads a codeword with the LLR levels in a device-memory
scratch, which walks the chunk as a schedule (scl_chunk_schedule,
widened by `wide_chunk_ops`).

A prune round ranks candidates by (value desc, flat code l*C + c asc) and
leaves _NEG on the candidate it took, as the TPU kernel's iterative
extraction does: once only values <= _NEG remain (inactive list
slots), a taken candidate can be taken again. This shows only in inactive
slots. The kernels compute the same result by rank with the re-take rule
written out: up to 32 paths each candidate counts the candidates that
beat it; above, the C lists of a leaf (list c: the candidates (l, c) in
path order) are merged, a list already in rank order (a bit's keep list:
every prune leaves its slots in rank order) taken as it is, the others
ranked in runs of 32 paths and merged by binary search. `prune_by_rank`
is the rank computation in torch ops, held against the iterative prune
by the CPU tests, and the plain version prunes with it.

`masked_sc_chunk` and `masked_scl_chunk` run their plain versions for CPU
tensors and the CUDA kernels for CUDA tensors, never one in place of the
other. The plain versions recurse over the chunk in torch ops and sum in
span order, as the kernels do, and the build disables FMA contraction, so
each pair agrees bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .fg import f_minsum, f_minsum_sat
from .scl_kernel_bl import (
    SPC_TABLE,
    _Char,
    MAX_LIST,
    WIDE_FAMILY_CODES,
    _Float,
    _Plain,
    _bind_wide,
    _stream_of,
    n_words,
    pack01,
    packed_bipolar,
    take_packed,
    take_state,
    take_vec,
    wide_scratch,
)
from ..models.tree import CodeNode, NodeKind

_NEG = -1.0e30  # metric of an inactive list slot (models/scl.py)
MAX_SC_CHUNK = 8192  # K6 keeps 2M f32 LLRs and 2M bytes of bits on chip
SCL_LISTS = (2, 4, 8, 16, 32)  # K7's list sizes with a kernel of their own size
MAX_SCL_SMEM = 200 * 1024  # K7's LLR levels and bit words, per codeword
# kernel launches since the counts were last reset: "sc"/"scl" the float32
# family, "sc_char"/"scl_char" the char family
LAUNCHES: Dict[str, int] = {"sc": 0, "scl": 0, "sc_char": 0, "scl_char": 0}
# K7 launches per (family, list size), every family (cleared by the caller)
SCL_LIST_LAUNCHES: Dict[Tuple[str, int], int] = {}
# of LAUNCHES' "scl"/"scl_char", those of the device-memory kernel
# (csrc/scl_wide.cu), per family
SCL_WIDE_LAUNCHES: Dict[str, int] = {"float32": 0, "char": 0}
# the chunk kernels' families: K1's rule sets on float32 state (their
# codes are the kernels' family codes too); K6's f is the product form
_FAMILIES = {"float32": _Float, "char": _Char}
_SC_F = {"float32": f_minsum, "char": f_minsum_sat}

# class code (models/large.py _MIXED.._SPC) -> SSCL leaf rule of a sub-block
_SUB_KINDS = (None, NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC)

OP_F, OP_G, OP_COMBINE, OP_BIT, OP_SUB = range(5)


def _check_chunk(m_len: int, limit: int, what: str) -> None:
    if m_len < 2 or m_len > limit or m_len & (m_len - 1):
        raise NotImplementedError(
            f"{what} covers power-of-2 chunks in [2, {limit}], got {m_len}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_family(family: str) -> None:
    if family not in _FAMILIES:
        raise ValueError(f"the chunk kernels' families are float32 and char, got {family!r}")


# ---- K6: masked SC ---------------------------------------------------------

def masked_sc_chunk_plain(llr: torch.Tensor, mask: torch.Tensor,
                          family: str = "float32"):
    """Plain version of K6 on any device: llr [B, M] f32, mask [M] (nonzero
    = frozen) -> (x, u) [B, M] bipolar f32."""
    _check_family(family)
    frozen = mask.cpu().numpy() != 0
    f_fn, g_fn, hard = _SC_F[family], _FAMILIES[family].g, _FAMILIES[family].hard

    def rec(x, lo):
        m = x.shape[1]
        if m == 1:
            u = torch.ones_like(x) if frozen[lo] else 1.0 - 2.0 * hard(x).to(x.dtype)
            return u, u
        half = m // 2
        a, b = x[:, :half], x[:, half:]
        x_l, u_l = rec(f_fn(a, b), lo)
        x_r, u_r = rec(g_fn(a, b, x_l), lo + half)
        return torch.cat([x_l * x_r, x_r], dim=1), torch.cat([u_l, u_r], dim=1)

    return rec(llr, 0)


def _bind_sc(lib):
    fn = lib.masked_sc_chunk
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_sc_chunk(llr: torch.Tensor, mask: torch.Tensor, family: str = "float32"):
    """K6: the plain version for CPU tensors, the CUDA kernel of `family`
    for CUDA tensors (same signature as masked_sc_chunk_plain; the mask is
    uint8 on the card)."""
    _check_family(family)
    if llr.device.type == "cpu":
        return masked_sc_chunk_plain(llr, mask, family)
    if llr.device.type != "cuda" or mask.device != llr.device:
        raise ValueError(
            f"masked_sc_chunk takes CPU or CUDA tensors on one device, got "
            f"{llr.device} and {mask.device}")
    if llr.dtype != torch.float32 or mask.dtype != torch.uint8:
        raise ValueError("masked_sc_chunk takes float32 LLRs and a uint8 mask")
    if llr.dim() != 2 or not (llr.is_contiguous() and mask.is_contiguous()):
        raise ValueError("masked_sc_chunk takes a contiguous [B, M] tensor")
    n_batch, m_len = llr.shape
    _check_chunk(m_len, MAX_SC_CHUNK, "the masked SC kernel")
    if mask.shape != (m_len,):
        raise ValueError(f"mask must be [{m_len}]")
    fn = _bind_sc(_build.load("large_sc_chunk"))
    x = torch.empty_like(llr)
    u = torch.empty_like(llr)
    err = fn(llr.data_ptr(), mask.data_ptr(), x.data_ptr(), u.data_ptr(), m_len,
             n_batch, _FAMILIES[family].code, _stream(llr.device))
    if err:
        raise RuntimeError(f"masked_sc_chunk launch failed: CUDA error {err}")
    LAUNCHES["sc" if family == "float32" else "sc_char"] += 1
    return x, u


# ---- K7: masked SCL --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sub_leaf(kind: NodeKind, span: int) -> CodeNode:
    """A leaf node of `kind` at `span`: what _Plain.leaf reads."""
    frozen = {NodeKind.RATE0: np.arange(span), NodeKind.RATE1: np.arange(0),
              NodeKind.REP: np.arange(span - 1), NodeKind.SPC: np.arange(1)}[kind]
    return CodeNode(offset=0, length=span, frozen=frozen, kind=kind)


class _RankPlain(_Plain):
    """K1's plain rules with K7's prune: the iterative extraction with the
    _NEG re-take rule, computed by rank (prune_by_rank, equal to
    _Plain(L, drop=_NEG).prune: tests/test_torch_prune_rank.py) in a
    fixed count of whole-tensor ops at any L, where the extraction takes L
    rounds of four ops at every bit."""

    def prune(self, metrics, deltas):
        if deltas.shape[0] * metrics.shape[0] <= self.n_list:
            return super().prune(metrics, deltas)
        return prune_by_rank(metrics, deltas, self.n_list)


def masked_scl_chunk_plain(llr: torch.Tensor, mask: torch.Tensor,
                           metrics: torch.Tensor,
                           sub_cls: Optional[torch.Tensor] = None,
                           family: str = "float32"):
    """Plain version of K7 on any device (same signature as
    masked_scl_chunk), at any list size. Works in K1's [w, S, B] layout
    with packed words ([W, S, B] above 32 paths), with K1's rules of the
    family on float32 state; f is the sign-XOR form in both families (on
    integers it is the char family's product form)."""
    _check_family(family)
    n_list, m_len = llr.shape[1], llr.shape[2]
    words = n_words(n_list)
    frozen = mask.cpu().numpy() != 0
    codes = None if sub_cls is None else sub_cls.cpu().numpy().tolist()
    sub = None if codes is None else m_len // len(codes)
    fam = _FAMILIES[family]
    plain = _RankPlain(n_list, drop=_NEG, fam=fam)

    def bit_leaf(x, lo, mets):
        work = x[:, 0]
        if frozen[lo]:
            deltas = torch.stack([torch.clamp(work, max=0.0), torch.full_like(work, _NEG)])
        else:
            deltas = torch.stack([torch.zeros_like(work), -work.abs()])
        new_m, src, cand = plain.prune(mets, deltas)
        if frozen[lo]:
            shape = (1, work.shape[1]) if words == 1 else (words, 1, work.shape[1])
            return torch.zeros(shape, dtype=torch.int32, device=x.device), src, new_m
        hard = fam.hard(x).to(torch.int32)
        bits = take_state(hard, src) ^ (cand == 1).to(torch.int32)[:, None]
        return pack01(bits, words), src, new_m

    def node(x, lo, mets, dispatch):
        m = x.shape[1]
        if m == 1:
            return bit_leaf(x, lo, mets)
        if dispatch and m == sub:
            kind = _SUB_KINDS[codes[lo // sub]]
            if kind is not None:
                return plain.leaf(_sub_leaf(kind, sub), x, mets)
            return node(x, lo, mets, False)
        half = m // 2
        a, b = x[:, :half], x[:, half:]
        left, p_left, mets = node(_Float.f(a, b), lo, mets, dispatch)
        if p_left is not None:
            xg = take_state(x, p_left)
            a, b = xg[:, :half], xg[:, half:]
        right, p_right, mets = node(fam.g(a, b, packed_bipolar(left, n_list, words)),
                                    lo + half, mets, dispatch)
        if p_right is not None:
            left = take_packed(left, p_right, n_list, words)
        perm = p_right if p_left is None else (
            p_left if p_right is None else take_vec(p_left, p_right))
        return torch.cat([left ^ right, right], dim=-2), perm, mets

    word, perm, met = node(llr.permute(1, 2, 0), 0, metrics.T, sub is not None)
    if perm is None:
        perm = torch.arange(n_list, device=llr.device)[:, None].expand_as(met)
    return (word.movedim(-1, 0).to(torch.int32).contiguous(),
            perm.T.to(torch.int32).contiguous(), met.T.contiguous())


def prune_by_rank(metrics: torch.Tensor, deltas: torch.Tensor, n_list: int):
    """K7's prune by rank, in torch ops (its twin; the plain version of K7
    prunes with it): metrics [w, B], deltas [C, w, B] with w * C > n_list
    -> (metrics' [L, B], src [L, B], cand [L, B]), equal to _Plain(n_list,
    drop=_NEG).prune. Candidate t = l*C + c has the value metrics[l] +
    deltas[c, l] and the rank #{u: v_u > v_t or (v_u == v_t and u < t)}.
    With k values above _NEG, slots r < max(k, 1) take rank r with its
    value; every later slot takes the smallest code among the candidates
    taken and those whose value is exactly _NEG, with value _NEG: the
    iterative extraction's re-take rule (each taken candidate is left at
    _NEG)."""
    n_cand, width = deltas.shape[0], metrics.shape[0]
    total = width * n_cand
    if total <= n_list:
        raise ValueError(f"{width} paths x {n_cand} candidates do not exceed L = {n_list}")
    flat = (metrics[None] + deltas).permute(1, 0, 2).reshape(total, -1)  # [T, B]
    codes = torch.arange(total, device=flat.device)
    v_t, v_u = flat[:, None], flat[None, :]  # candidate t against candidate u
    beats = (v_u > v_t) | ((v_u == v_t) & (codes[None, :, None] < codes[:, None, None]))
    rank = beats.sum(dim=1)  # [T, B], a permutation of 0..T-1 per column
    by_rank = torch.empty_like(rank).scatter_(0, rank, codes[:, None].expand_as(rank))
    taken_n = torch.clamp((flat > _NEG).sum(dim=0), min=1)  # max(k, 1)
    pool = (rank < taken_n[None]) | (flat == _NEG)
    retake = torch.where(pool, codes[:, None], total).min(dim=0).values
    slot = torch.arange(n_list, device=flat.device)[:, None]
    live = slot < taken_n[None]
    code = torch.where(live, by_rank[:n_list], retake[None])
    value = torch.where(live, torch.gather(flat, 0, by_rank[:n_list]),
                        torch.full_like(flat[:n_list], _NEG))
    return value, code // n_cand, code % n_cand


@functools.lru_cache(maxsize=None)
def scl_chunk_schedule(m_len: int, sub: int) -> np.ndarray:
    """K7's walk of one chunk (sub = 0: per-bit to span 1): [n_ops, 5] int32
    rows {op, level, length, offset, skip} in post-order. OP_SUB marks a
    sub-block: the kernel reads its class and, for a pure one, applies the
    leaf rule and skips the `skip` rows after it (the sub-block's per-bit
    recursion, which a mixed sub-block runs)."""
    ops = []

    def emit(level, length, off, in_sub):
        if length == 1:
            ops.append([OP_BIT, level, 1, off, 0])
            return
        if sub and length == sub and not in_sub:
            at = len(ops)
            ops.append([OP_SUB, level, length, off, 0])
            emit(level, length, off, True)
            ops[at][4] = len(ops) - at - 1
            return
        half = length // 2
        ops.append([OP_F, level, length, off, 0])
        emit(level + 1, half, off, in_sub)
        ops.append([OP_G, level, length, off, 0])
        emit(level + 1, half, off + half, in_sub)
        ops.append([OP_COMBINE, level, length, off, 0])

    emit(0, m_len, 0, False)
    return np.asarray(ops, np.int32)


@functools.lru_cache(maxsize=None)
def _scl_consts(dev: torch.device):
    """(SPC table, a stand-in for absent class codes) on `dev`."""
    return (torch.as_tensor(SPC_TABLE, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def _bind_scl(lib):
    fn = lib.masked_scl_chunk
    if fn.argtypes is None:  # first use of this library
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def scl_chunk_smem(n_list: int, m_len: int, sub: int = 0, direct: bool = False) -> int:
    """Shared-memory bytes of one codeword of the shared-memory K7 kernels
    besides their fixed bookkeeping (the perms, the candidates and, above
    32 paths, the merge's ordered lists: static, beside these): the LLR
    levels (8 L M bytes, or 4 L M with level 0 read from device memory:
    `direct`), W words of packed bits a position (those of the capacity
    that serves L: 1 up to 32 paths, 2 up to 64, 4 up to MAX_LIST;
    n_words(L) above, which those kernels do not take), the mask bits and
    the class codes. The kernels compute the same (csrc/large_scl_lists.cu
    dynamic_bytes) and read level 0 from device memory where the staged
    state exceeds MAX_SCL_SMEM."""
    words = (1 if n_list <= 32 else 2 if n_list <= 64 else 4 if n_list <= MAX_LIST
             else n_words(n_list))
    return ((4 if direct else 8) * n_list * m_len + 4 * words * m_len
            + 4 * ((m_len + 31) // 32) + (m_len // sub if sub else 0))


def scl_library(n_list: int, m_len: int, sub: int = 0) -> str:
    """The K7 library that serves L paths on chunks of m_len: the kernels of
    a fixed list size (L in SCL_LISTS, the whole pyramid on chip), those of
    a capacity with the list size at run time (any other L up to MAX_LIST,
    and these where the pyramid does not fit), or the device-memory kernel
    (L > MAX_LIST, or a state past MAX_SCL_SMEM even with level 0 in
    device memory)."""
    if n_list > MAX_LIST or scl_chunk_smem(n_list, m_len, sub, direct=True) > MAX_SCL_SMEM:
        return "scl_wide"
    if n_list in SCL_LISTS and scl_chunk_smem(n_list, m_len, sub) <= MAX_SCL_SMEM:
        return "large_scl_chunk"
    return "large_scl_lists"


def masked_scl_chunk(llr: torch.Tensor, mask: torch.Tensor, metrics: torch.Tensor,
                     sub_cls: Optional[torch.Tensor] = None, family: str = "float32"):
    """K7: (llr [B, L, M] f32, mask [M] u8, metrics [B, L] f32, sub_cls
    [M / sub] i32 or None) -> (bits [B, M] i32, or [B, W, M] for L > 32
    with W = ceil(L / 32) words; perm [B, L] i32; metrics [B, L] f32). The
    plain version for CPU tensors, a CUDA kernel of `family` for CUDA
    tensors, at any L >= 1 and any power-of-2 chunk up to 2^15
    (scl_library picks the kernel); a device-memory scratch larger than
    the card's memory raises MemoryError."""
    _check_family(family)
    if llr.device.type == "cpu":
        return masked_scl_chunk_plain(llr, mask, metrics, sub_cls, family)
    dev = llr.device
    args = [mask, metrics] + ([] if sub_cls is None else [sub_cls])
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError(
            f"masked_scl_chunk takes CPU or CUDA tensors on one device, got "
            f"{[str(t.device) for t in [llr] + args]}")
    if (llr.dtype != torch.float32 or metrics.dtype != torch.float32
            or mask.dtype != torch.uint8
            or (sub_cls is not None and sub_cls.dtype != torch.int32)):
        raise ValueError("masked_scl_chunk takes float32 LLRs and metrics, a uint8 "
                         "mask and int32 class codes")
    if llr.dim() != 3 or not all(t.is_contiguous() for t in [llr] + args):
        raise ValueError("masked_scl_chunk takes contiguous tensors, llr [B, L, M]")
    n_batch, n_list, m_len = llr.shape
    if n_list < 1:
        raise ValueError("masked_scl_chunk takes at least one path")
    _check_chunk(m_len, 1 << 15, "the masked SCL kernel")
    if mask.shape != (m_len,) or metrics.shape != (n_batch, n_list):
        raise ValueError(f"mask must be [{m_len}] and metrics [{n_batch}, {n_list}]")
    sub = 0
    if sub_cls is not None:
        sub = m_len // sub_cls.numel()
        if sub < 2 or sub * sub_cls.numel() != m_len or sub & (sub - 1):
            raise ValueError(f"{sub_cls.numel()} class codes do not cut {m_len} "
                             "into power-of-2 sub-blocks")
    name = scl_library(n_list, m_len, sub)
    if name == "scl_wide":
        out = launch_scl_wide(_build.load(name), llr, mask, metrics, sub_cls, family)
        SCL_WIDE_LAUNCHES[family] += 1
    else:
        out = launch_scl(_build.load(name), llr, mask, metrics, sub_cls, family)
    LAUNCHES["scl" if family == "float32" else "scl_char"] += 1
    SCL_LIST_LAUNCHES[family, n_list] = SCL_LIST_LAUNCHES.get((family, n_list), 0) + 1
    return out


def launch_scl(lib, llr: torch.Tensor, mask: torch.Tensor, metrics: torch.Tensor,
               sub_cls: Optional[torch.Tensor] = None, family: str = "float32"):
    """Launch K7 from the loaded library `lib` on checked CUDA tensors (the
    wrapper's launch; chip_profile.py times other builds through it)."""
    n_batch, n_list, m_len = llr.shape
    dev = llr.device
    sub = 0 if sub_cls is None else m_len // sub_cls.numel()
    words = n_words(n_list)
    fn = _bind_scl(lib)
    spc, none = _scl_consts(dev)
    shape = (n_batch, m_len) if words == 1 else (n_batch, words, m_len)
    bits = torch.empty(shape, dtype=torch.int32, device=dev)
    perm = torch.empty((n_batch, n_list), dtype=torch.int32, device=dev)
    met = torch.empty((n_batch, n_list), dtype=torch.float32, device=dev)
    # the kernel walks the chunk itself: no schedule (ops, n_ops) is passed
    err = fn(None, 0, spc.data_ptr(), llr.data_ptr(),
             mask.data_ptr(), metrics.data_ptr(),
             (none if sub_cls is None else sub_cls).data_ptr(), sub,
             bits.data_ptr(), perm.data_ptr(), met.data_ptr(), n_list, m_len, n_batch,
             _FAMILIES[family].code, _stream(dev))
    if err:
        raise RuntimeError(f"masked_scl_chunk launch failed: CUDA error {err}")
    return bits, perm, met


@functools.lru_cache(maxsize=None)
def wide_chunk_ops(m_len: int, sub: int, dev: torch.device) -> torch.Tensor:
    """scl_chunk_schedule widened to the device-memory kernel's 8-int ops
    {op, level, length, offset, kind, aux, ncand, skip} on `dev`: a bit is
    a LEAF of kind BIT (5) with 2 candidates, a sub-block keeps its skip in
    column 7."""
    sched = scl_chunk_schedule(m_len, sub)
    ops = np.zeros((sched.shape[0], 8), np.int32)
    ops[:, :4] = sched[:, :4]
    bit = sched[:, 0] == OP_BIT
    ops[bit, 4], ops[bit, 6] = 5, 2
    ops[:, 7] = np.where(sched[:, 0] == OP_SUB, sched[:, 4], 0)
    return torch.as_tensor(ops, device=dev)


def launch_scl_wide(lib, llr: torch.Tensor, mask: torch.Tensor, metrics: torch.Tensor,
                    sub_cls: Optional[torch.Tensor] = None, family: str = "float32"):
    """Launch K7's device-memory kernel from the loaded library `lib` (the
    build of csrc/scl_wide.cu, or its CPU build) on checked tensors."""
    n_batch, n_list, m_len = llr.shape
    dev = llr.device
    sub = 0 if sub_cls is None else m_len // sub_cls.numel()
    words = n_words(n_list)
    _bind_wide(lib)
    spc, none = _scl_consts(dev)
    ops = wide_chunk_ops(m_len, sub, dev)
    code = WIDE_FAMILY_CODES["float32" if family == "float32" else "chunk_char"]
    scratch = wide_scratch(lib, dev, n_batch, n_list, m_len, m_len.bit_length(),
                           8 if sub else 2, code, "masked_scl_chunk")
    shape = (n_batch, m_len) if words == 1 else (n_batch, words, m_len)
    bits = torch.empty(shape, dtype=torch.int32, device=dev)
    perm = torch.empty((n_batch, n_list), dtype=torch.int32, device=dev)
    met = torch.empty((n_batch, n_list), dtype=torch.float32, device=dev)
    err = lib.masked_scl_chunk_wide(
        ops.data_ptr(), ops.shape[0], spc.data_ptr(), llr.data_ptr(), mask.data_ptr(),
        metrics.data_ptr(), (none if sub_cls is None else sub_cls).data_ptr(), sub,
        bits.data_ptr(), perm.data_ptr(), met.data_ptr(), scratch.data_ptr(), n_list, m_len,
        n_batch, _FAMILIES[family].code, _stream_of(dev))
    if err:
        raise RuntimeError(f"masked_scl_chunk (device-memory kernel) launch failed: CUDA "
                           f"error {err}")
    return bits, perm, met
