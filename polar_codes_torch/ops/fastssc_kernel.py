"""Fast-SSC subtree kernel K3 (csrc/fastssc_subtree.cu), its plain version,
and the schedule that carries a subtree to the kernel as data.

Counterpart of polar_codes_tpu/ops/fastssc_kernel.py: one call decodes a
whole span <= kernel_span subtree of the Fast-SSC tree for a batch of
codewords, in the TPU kernel's batch-minor layout,

    llr [span, B] (float32, bfloat16, or int8 for the char family)
        -> root call:   bits [span, B] uint8          (the TPU `kernel`)
           below glue:  bipolar state [span, B] +-1   (the TPU `kernel_bits`)

in one of three families, chosen by the LLRs' dtype: float32 (f on the
raw bits, hard decision by the sign bit, ZeroR a plain b + a), bfloat16
(the TPU kernel's `_Ops` for a 16-bit float state: f in product form, g =
b +- a and ZeroR b + a each rounded to bf16 once on store; leaves compute
in float32 on the stored values, the REP sum in span order; decisions by
the sign bit) or the saturating char family on int8 LLRs (f in product
form, f, g and ZeroR clipped to [-127, 127], hard decision llr < 0). The
TPU kernel is traced per subtree; here `build_schedule` flattens the
subtree once on the host into a post-order op list (F, G, ZERO_R,
COMBINE, LEAF), and one CUDA kernel per family runs any schedule.

`fastssc_subtree` runs `fastssc_subtree_plain` for tensors on the CPU and
the CUDA kernel for tensors on the card, never one in place of the other.
The plain version walks the node tree itself and does not read the op
list, so the two versions check each other. Its float REP sum runs
sequentially over the span, in the kernel's order, so the two agree bit
for bit. f's clip acts only on an int8 input of -128, which the
simulator's quantiser never produces: there the JAX package's two char
forms disagree (f_minsum_i8 wraps to -128, f_minsum_sat gives 128), and
the port saturates to 127 in the kernel and the plain version alike.

The JAX package's two bf16 arms differ: its XLA decoder sums a REP leaf in
bf16 and decides with jnp.sign, its Pallas kernel sums in f32 and decides
by the sign bit, so a few codewords differ between them. The port follows
the Pallas kernel, the one this kernel replaces.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from . import _build
from .fg import f_minsum, f_minsum_bits, g_update, g_update_i8
from ..models.tree import CodeNode, NodeKind

MAX_SPAN = 2048  # shared memory holds [2 * span] LLRs + [span] bits per codeword
LAUNCHES = {"float32": 0, "int8": 0, "bfloat16": 0}  # kernel launches per family since the last reset

OP_F, OP_G, OP_ZERO_R, OP_COMBINE, OP_LEAF = range(5)
_KIND_CODE = {NodeKind.RATE0: 0, NodeKind.RATE1: 1, NodeKind.REP: 2, NodeKind.SPC: 3}
_DTYPES = {torch.float32: "float32", torch.int8: "int8", torch.bfloat16: "bfloat16"}
_FAMILY_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}  # the kernel's `family`


@dataclass(eq=False)
class FastSSCSchedule:
    """One subtree, flattened for the kernel: `ops` [n_ops, 5] int32 rows
    {op, level, length, offset, kind} in post-order."""

    node: CodeNode
    ops: np.ndarray
    _device_ops: Dict[torch.device, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def span(self) -> int:
        return self.node.length

    def device_ops(self, device: torch.device) -> torch.Tensor:
        ops = self._device_ops.get(device)
        if ops is None:
            ops = torch.as_tensor(self.ops, device=device)
            self._device_ops[device] = ops
        return ops


def build_schedule(node: CodeNode) -> FastSSCSchedule:
    """Flatten the Fast-SSC subtree rooted at `node`."""
    ops = []
    root = node.offset

    def emit(n: CodeNode, level: int):
        off = n.offset - root
        if n.kind != NodeKind.BRANCH:
            if n.kind not in _KIND_CODE:
                raise ValueError(f"Fast-SSC has no {n.kind.value} leaves")
            ops.append([OP_LEAF, level, n.length, off, _KIND_CODE[n.kind]])
            return
        if n.left.kind == NodeKind.RATE0:  # ZeroR: left bits 0, g = b + a
            ops.append([OP_ZERO_R, level, n.length, off, 0])
        else:
            ops.append([OP_F, level, n.length, off, 0])
            emit(n.left, level + 1)
            ops.append([OP_G, level, n.length, off, 0])
        emit(n.right, level + 1)
        ops.append([OP_COMBINE, level, n.length, off, 0])

    emit(node, 0)
    return FastSSCSchedule(node=node, ops=np.asarray(ops, np.int32).reshape(-1, 5))


# ---- the two families (plain torch) ----------------------------------------

class _Float:
    f = staticmethod(f_minsum_bits)
    g = staticmethod(g_update)

    @staticmethod
    def zero_r(a, b):
        return b + a

    @staticmethod
    def hard(x):
        """Bipolar decision by the sign bit (-0.0 decides -1)."""
        return torch.where(torch.signbit(x), -1.0, 1.0).to(x.dtype)

    @staticmethod
    def rep_sum(x):
        """Sum over the span, one add at a time from 0 (the kernel's order)."""
        acc = torch.zeros_like(x[0])
        for s in range(x.shape[0]):
            acc = acc + x[s]
        return acc


class _Bf16:
    """bf16 state: f and g on the stored values, each result rounded to
    bf16 once; leaves widen to float32."""

    @staticmethod
    def f(a, b):
        return f_minsum(a, b)  # exact: one of the inputs' magnitudes

    @staticmethod
    def g(a, b, left_bipolar):
        return (b.float() + left_bipolar.float() * a.float()).to(torch.bfloat16)

    @staticmethod
    def zero_r(a, b):
        return (b.float() + a.float()).to(torch.bfloat16)

    @staticmethod
    def hard(x):
        return _Float.hard(x.float()).to(x.dtype)

    @staticmethod
    def rep_sum(x):
        return _Float.rep_sum(x.float())


class _Char:
    g = staticmethod(g_update_i8)

    @staticmethod
    def f(a, b):
        """f_minsum_i8, clipped to [-127, 127] instead of wrapping at 128."""
        a16, b16 = a.to(torch.int16), b.to(torch.int16)
        f = torch.sign(a16) * torch.sign(b16) * torch.minimum(a16.abs(), b16.abs())
        return torch.clamp(f, -127, 127).to(torch.int8)

    @staticmethod
    def zero_r(a, b):
        return g_update_i8(a, b, torch.ones_like(a))

    @staticmethod
    def hard(x):
        """Bipolar decision llr < 0 (0 decides +1)."""
        return torch.where(x < 0, -1, 1).to(torch.int8)

    @staticmethod
    def rep_sum(x):
        return x.to(torch.int32).sum(dim=0)  # exact, no saturation


def _leaf(node: CodeNode, llr, fam):
    if node.kind == NodeKind.RATE0:
        return torch.ones_like(llr)
    if node.kind == NodeKind.RATE1:
        return fam.hard(llr)
    if node.kind == NodeKind.REP:
        return fam.hard(fam.rep_sum(llr))[None].expand_as(llr).to(llr.dtype)
    # SPC: hard decisions; if their parity is odd, flip the weakest (the
    # lowest index among equal minimum magnitudes)
    hard = fam.hard(llr)
    mag = llr.to(torch.int32).abs() if llr.dtype == torch.int8 else llr.float().abs()
    odd = (hard < 0).sum(dim=0) % 2 == 1
    span = llr.shape[0]
    iota = torch.arange(span, device=llr.device)[:, None]
    weakest = torch.where(mag == mag.min(dim=0).values[None], iota, span).min(dim=0).values
    flip = (iota == weakest[None]) & odd[None]
    return torch.where(flip, -hard, hard)


def _emit(node: CodeNode, llr, fam):
    """Bipolar decisions [span, B] of the subtree at `node` (fastssc_kernel.py
    _emit on torch tensors)."""
    if node.kind != NodeKind.BRANCH:
        return _leaf(node, llr, fam)
    half = node.length // 2
    a, b = llr[:half], llr[half:]
    if node.left.kind == NodeKind.RATE0:
        right = _emit(node.right, fam.zero_r(a, b), fam)
        return torch.cat([right, right], dim=0)
    left = _emit(node.left, fam.f(a, b), fam)
    right = _emit(node.right, fam.g(a, b, left), fam)
    return torch.cat([left * right, right], dim=0)


def family(dtype: torch.dtype):
    """The arithmetic of the LLR dtype: _Float for float32, _Bf16 for
    bfloat16, _Char for int8."""
    if dtype not in _DTYPES:
        raise ValueError(f"Fast-SSC takes bfloat16, float32 or int8 LLRs, got {dtype}")
    return {torch.int8: _Char, torch.bfloat16: _Bf16}.get(dtype, _Float)


def fastssc_subtree_plain(sched: FastSSCSchedule, llr: torch.Tensor, root: bool):
    """Plain version of K3, on any device: llr [span, B] float32, bfloat16
    or int8 -> uint8 bits [span, B] if root, else bipolar state in llr's
    dtype."""
    state = _emit(sched.node, llr, family(llr.dtype))
    if root:
        return (state < 0).to(torch.uint8)
    return state.contiguous()


def _bind(lib):
    """The library's entry point, its types set on first use."""
    fn = lib.fastssc_subtree
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch(lib, sched: FastSSCSchedule, llr: torch.Tensor, root: bool) -> torch.Tensor:
    """Launch K3 from the loaded library `lib` (the nvcc build, or the CPU
    build of ops/_emu.py on CPU tensors) on a checked llr [span, B]."""
    fn = _bind(lib)
    dev = llr.device
    ops = sched.device_ops(dev)
    n_batch = llr.shape[1]
    out = torch.empty((sched.span, n_batch), device=dev,
                      dtype=torch.uint8 if root else llr.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    err = fn(ops.data_ptr(), ops.shape[0], llr.data_ptr(), out.data_ptr(),
             _FAMILY_CODES[llr.dtype], int(bool(root)), sched.span, n_batch, stream)
    if err:
        raise RuntimeError(f"fastssc_subtree launch failed: CUDA error {err}")
    return out


def fastssc_subtree(sched: FastSSCSchedule, llr: torch.Tensor, root: bool):
    """K3: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (same signature as fastssc_subtree_plain)."""
    if llr.device.type == "cpu":
        return fastssc_subtree_plain(sched, llr, root)
    if llr.device.type != "cuda":
        raise ValueError(f"fastssc_subtree takes CPU or CUDA tensors, got {llr.device}")
    name = _DTYPES.get(llr.dtype)
    if name is None:
        raise ValueError(
            f"fastssc_subtree takes bfloat16, float32 or int8 LLRs, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[0] != sched.span:
        raise ValueError(
            f"fastssc_subtree expects llr [{sched.span}, B], got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("fastssc_subtree takes a contiguous tensor")
    if sched.span > MAX_SPAN:
        raise NotImplementedError(
            f"the kernel covers spans up to {MAX_SPAN}, got {sched.span}")
    out = launch(_build.load("fastssc_subtree"), sched, llr, root)
    LAUNCHES[name] += 1
    return out
