"""SCAN sweep kernels K4 (fused) and K5 (stepped) (csrc/scan_sweep.cu),
their plain versions, the packed node-memory layout, and the schedule that
carries the tree to the kernels as data.

Counterpart of polar_codes_tpu/ops/scan_kernel.py, in its batch-minor
layouts:

    K4  scan_fused(sched, llr [N, B], sweeps) -> beta [N, B]
    K5  scan_step(sched, llr [N, B], mem [M, B]) -> (beta [N, B], mem' [M, B])

K4 runs every sweep in one call with the inter-sweep node memory on chip;
K5 runs one sweep and carries the memory in the packed [M, B] buffer
(`mem_layout`, post-order, the JAX `_mem_layout`), so that FastSSCAN can
check the CRC between sweeps. The memory starts at zeros. f is the
product-form min-sum (0 at zeros), rate-0 betas are +inf and rate-1 betas
0; everything is elementwise, so kernel, plain version and the JAX
package agree bit for bit.

`scan_fused` and `scan_step` run the plain versions for tensors on the CPU
and the CUDA kernel for tensors on the card, never one in place of the
other. The plain versions walk the node tree themselves and do not read
the op list, so the two versions check each other. On the card a warp
runs the sweeps of one or two codewords (csrc/scan_sweep.cu) on the
schedule's `kernel_ops`; `launch_fused` and `launch_step` take the
library to launch from, so that the tests can run the kernel's source
built for the CPU (ops/_emu.py) on CPU tensors, and the node-memory
placement and warp layout, which the wrappers leave to the kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build
from .fg import f_minsum
from ..models.tree import CodeNode, NodeKind

MAX_N = 4096  # shared memory holds [3 * N] floats per codeword
LAUNCHES = {"fused": 0, "step": 0}  # kernel launches since the last reset

OP_F, OP_G, OP_COMBINE, OP_LEAF = range(4)


def mem_layout(tree: CodeNode) -> Tuple[Dict[CodeNode, int], int]:
    """Row offset of each branch node's beta_r block in the packed [M, B]
    node memory, in post-order, and M (the sum of the half-spans)."""
    offsets = {}
    total = 0

    def walk(node: CodeNode):
        nonlocal total
        if node.kind != NodeKind.BRANCH:
            return
        walk(node.left)
        walk(node.right)
        offsets[node] = total
        total += node.length // 2

    walk(tree)
    return offsets, total


@dataclass(eq=False)
class ScanSchedule:
    """The SCAN tree flattened: `ops` [n_ops, 5] int32 rows {op, level,
    length, offset, aux} in post-order (aux: the node's memory row for
    F/G/COMBINE; 0 for a rate-0, 1 for a rate-1 leaf), and `kernel_ops`,
    the kernels' derived copy (see `kernel_ops`)."""

    tree: CodeNode
    ops: np.ndarray
    mem_offsets: Dict[CodeNode, int]
    mem_rows: int
    kernel_ops: np.ndarray
    _device_ops: Dict[torch.device, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def block_length(self) -> int:
        return self.tree.length

    def device_ops(self, device: torch.device) -> torch.Tensor:
        """`kernel_ops` on `device` (made once per device)."""
        ops = self._device_ops.get(device)
        if ops is None:
            ops = torch.as_tensor(self.kernel_ops, device=device)
            self._device_ops[device] = ops
        return ops


def build_schedule(tree: CodeNode) -> ScanSchedule:
    """Flatten a SCAN tree (leaves RATE0 and RATE1 only, a branch root)."""
    if tree.kind != NodeKind.BRANCH:
        raise ValueError("degenerate single-leaf tree: nothing to sweep")
    offsets, rows = mem_layout(tree)
    ops = []

    def emit(n: CodeNode, level: int):
        if n.kind == NodeKind.RATE0 or n.kind == NodeKind.RATE1:
            ops.append([OP_LEAF, level, n.length, n.offset,
                        0 if n.kind == NodeKind.RATE0 else 1])
            return
        if n.kind != NodeKind.BRANCH:
            raise ValueError(f"SCAN has no {n.kind.value} leaves")
        mo = offsets[n]
        ops.append([OP_F, level, n.length, n.offset, mo])
        emit(n.left, level + 1)
        ops.append([OP_G, level, n.length, n.offset, mo])
        emit(n.right, level + 1)
        ops.append([OP_COMBINE, level, n.length, n.offset, mo])

    emit(tree, 0)
    return ScanSchedule(tree=tree, ops=np.asarray(ops, np.int32).reshape(-1, 5),
                        mem_offsets=offsets, mem_rows=rows,
                        kernel_ops=kernel_ops(tree, offsets))


CHILD_BRANCH, CHILD_RATE0, CHILD_RATE1, CHILD_NONE = range(4)
OP_SUBTREE = 3  # a kernel op: the whole sweep of a branch node of length SUBTREE
SUBTREE = 8


def kernel_ops(tree: CodeNode, offsets: Dict[CodeNode, int]) -> np.ndarray:
    """The schedule as csrc/scan_sweep.cu reads it: [n, 4] int32, the
    ops in post-order, {word, alpha row, z, memory row}: word = op |
    log2(length) << 2 | left child's kind << 6 | right child's kind << 8
    (CHILD_BRANCH, or a leaf: CHILD_RATE0, beta +inf; CHILD_RATE1, beta
    0); the alpha row is where the node's level starts in [2N] (level
    d >= 1 at 2N - 2N / 2^d); z is the node's beta offset for G and
    COMBINE, 0 for F.

    A branch node of length SUBTREE is one op, OP_SUBTREE, that sweeps its
    whole subtree in one lane's registers: word = OP_SUBTREE | the kinds
    of its 14 descendants << 2 (2 bits each, in heap order: node p's
    children are 2p and 2p + 1, the root 1, node p at bits 2p - 4;
    CHILD_NONE where the node does not exist), z its beta offset, and the
    memory row of its first branch node in post-order.

    A leaf's alpha is never read (its beta is a constant), so the F that
    feeds a leaf left child and the G that feeds a leaf right child are
    left out, and so are the leaves: G and COMBINE take a leaf child's
    constant beta from the word instead of reading it. Every value that
    is computed is computed as in `_sweep`; the ones left out are not
    read by anything."""
    n = tree.length
    rows = []

    def kind(node: CodeNode) -> int:
        if node.kind == NodeKind.BRANCH:
            return CHILD_BRANCH
        return CHILD_RATE0 if node.kind == NodeKind.RATE0 else CHILD_RATE1

    def subtree_word(node: CodeNode) -> int:
        word, heap = OP_SUBTREE, {1: node}
        for p in range(2, 2 * SUBTREE):
            parent = heap.get(p // 2)
            child = None
            if parent is not None and parent.kind == NodeKind.BRANCH:
                child = parent.right if p % 2 else parent.left
                heap[p] = child
            word |= (CHILD_NONE if child is None else kind(child)) << (2 * p - 2)
        return word

    def first_row(node: CodeNode) -> int:
        for child in (node.left, node.right):
            if child.kind == NodeKind.BRANCH:
                return first_row(child)
        return offsets[node]

    def emit(node: CodeNode, level: int):
        if node.kind != NodeKind.BRANCH:
            return
        lk, rk = kind(node.left), kind(node.right)
        word = (node.length.bit_length() - 1) << 2 | lk << 6 | rk << 8
        alpha = 0 if level == 0 else 2 * n - (n >> (level - 1))
        if node.length == SUBTREE:
            rows.append([subtree_word(node), alpha, node.offset, first_row(node)])
            return
        if lk == CHILD_BRANCH:
            rows.append([OP_F | word, alpha, 0, offsets[node]])
            emit(node.left, level + 1)
        if rk == CHILD_BRANCH:
            rows.append([OP_G | word, alpha, node.offset, offsets[node]])
            emit(node.right, level + 1)
        rows.append([OP_COMBINE | word, alpha, node.offset, offsets[node]])

    emit(tree, 0)
    return np.asarray(rows, np.int32).reshape(-1, 4)


# ---- the plain versions ----------------------------------------------------

def _sweep(node: CodeNode, alpha, mem, new_mem):
    """One SCAN sweep on [span, B] tensors (scan_kernel.py _sweep); mem and
    new_mem map a branch node to its beta_r [half, B]."""
    if node.kind == NodeKind.RATE0:
        return torch.full_like(alpha, float("inf"))
    if node.kind == NodeKind.RATE1:
        return torch.zeros_like(alpha)
    half = node.length // 2
    a, b = alpha[:half], alpha[half:]
    prev = mem.get(node)
    if prev is None:
        prev = torch.zeros_like(b)
    beta_l = _sweep(node.left, f_minsum(a, b + prev), mem, new_mem)
    beta_r = _sweep(node.right, b + f_minsum(a, beta_l), mem, new_mem)
    new_mem[node] = beta_r
    return torch.cat([f_minsum(beta_l, b + beta_r), beta_r + f_minsum(beta_l, a)], dim=0)


def scan_fused_plain(sched: ScanSchedule, llr: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Plain version of K4, on any device: llr [N, B] f32 -> beta [N, B]."""
    mem = {}
    beta = torch.zeros_like(llr)
    for _ in range(sweeps):
        new_mem = {}
        beta = _sweep(sched.tree, llr, mem, new_mem)
        mem = new_mem
    return beta


def scan_step_plain(sched: ScanSchedule, llr: torch.Tensor, mem: torch.Tensor):
    """Plain version of K5, on any device: (llr [N, B], mem [M, B]) f32 ->
    (beta [N, B], mem' [M, B])."""
    unpacked = {node: mem[off : off + node.length // 2]
                for node, off in sched.mem_offsets.items()}
    new_mem = {}
    beta = _sweep(sched.tree, llr, unpacked, new_mem)
    order = sorted(sched.mem_offsets, key=sched.mem_offsets.get)
    return beta, torch.cat([new_mem[node] for node in order], dim=0)


# ---- the wrappers ----------------------------------------------------------

def _check(name: str, sched: ScanSchedule, llr: torch.Tensor, *others) -> None:
    if llr.device.type != "cuda" or any(t.device != llr.device for t in others):
        raise ValueError(f"{name} takes CPU or CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in (llr,) + others):
        raise ValueError(f"{name} takes float32 tensors")
    if llr.dim() != 2 or llr.shape[0] != sched.block_length:
        raise ValueError(
            f"{name} expects llr [{sched.block_length}, B], got {tuple(llr.shape)}")
    if any(t.shape != (sched.mem_rows, llr.shape[1]) for t in others):
        raise ValueError(f"{name} expects mem [{sched.mem_rows}, {llr.shape[1]}]")
    if not all(t.is_contiguous() for t in (llr,) + others):
        raise ValueError(f"{name} takes contiguous tensors")
    if sched.block_length > MAX_N:
        raise NotImplementedError(
            f"the SCAN kernels cover N up to {MAX_N}, got {sched.block_length}")


def _bind(lib):
    """The library's entry points (fused, step), their types set."""
    fused, step = lib.scan_sweep_fused, lib.scan_sweep_step
    if fused.argtypes is None:  # first use of this library
        fused.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fused.restype = ctypes.c_int
        step.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        step.restype = ctypes.c_int
        lib.scan_sweep_mem_on_chip.argtypes = [ctypes.c_int] * 3
        lib.scan_sweep_mem_on_chip.restype = ctypes.c_int
        lib.scan_sweep_smem_limit.argtypes = []
        lib.scan_sweep_smem_limit.restype = ctypes.c_int
    return fused, step


def mem_on_chip(sched: ScanSchedule) -> bool:
    """Whether K4 keeps the node memory in shared memory (else in an
    [M, B] scratch that the wrapper allocates), as the kernel source
    chooses."""
    lib = _build.load("scan_sweep")
    _bind(lib)
    return bool(lib.scan_sweep_mem_on_chip(sched.block_length, sched.kernel_ops.shape[0],
                                           sched.mem_rows))


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None


def _raise(lib, name: str, sched: ScanSchedule, err: int, on_chip: bool) -> None:
    if err == -2:
        raise NotImplementedError(
            f"{name} keeps each codeword's alpha levels and betas"
            f"{' and node memory' if on_chip else ''} and the op list in shared memory: "
            f"N = {sched.block_length} with {sched.kernel_ops.shape[0]} ops and M = "
            f"{sched.mem_rows} exceeds the card's {lib.scan_sweep_smem_limit()} bytes "
            f"per block")
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch_fused(lib, sched: ScanSchedule, llr: torch.Tensor, sweeps: int, on_chip: bool, *,
                 per_block: int = 0, per_warp: int = 0) -> torch.Tensor:
    """Launch K4 from the loaded library `lib` on checked tensors, the
    node memory on chip or in a scratch; per_block warps a block (1 to 8)
    and per_warp codewords a warp (1 or 2), 0 the kernel's choice."""
    fused, _ = _bind(lib)
    dev = llr.device
    n_batch = llr.shape[1]
    ops = sched.device_ops(dev)
    scratch = torch.empty((1,) if on_chip else (sched.mem_rows, n_batch), device=dev)
    beta = torch.empty_like(llr)
    err = fused(ops.data_ptr(), ops.shape[0], llr.data_ptr(), beta.data_ptr(),
                scratch.data_ptr(), sched.mem_rows, int(on_chip), sched.block_length,
                n_batch, int(sweeps), per_block, per_warp, _stream(dev))
    _raise(lib, "scan_fused", sched, err, on_chip)
    return beta


def launch_step(lib, sched: ScanSchedule, llr: torch.Tensor, mem: torch.Tensor, *,
                per_block: int = 0, per_warp: int = 0):
    """Launch K5 from the loaded library `lib` on checked tensors, the
    layout as in `launch_fused`."""
    _, step = _bind(lib)
    dev = llr.device
    ops = sched.device_ops(dev)
    beta = torch.empty_like(llr)
    mem_out = torch.empty_like(mem)
    err = step(ops.data_ptr(), ops.shape[0], llr.data_ptr(), mem.data_ptr(),
               beta.data_ptr(), mem_out.data_ptr(), sched.mem_rows, sched.block_length,
               llr.shape[1], per_block, per_warp, _stream(dev))
    _raise(lib, "scan_step", sched, err, False)
    return beta, mem_out


def scan_fused(sched: ScanSchedule, llr: torch.Tensor, sweeps: int) -> torch.Tensor:
    """K4: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (same signature as scan_fused_plain)."""
    if llr.device.type == "cpu":
        return scan_fused_plain(sched, llr, sweeps)
    _check("scan_fused", sched, llr)
    lib = _build.load("scan_sweep")
    beta = launch_fused(lib, sched, llr, sweeps, mem_on_chip(sched))
    LAUNCHES["fused"] += 1
    return beta


def scan_step(sched: ScanSchedule, llr: torch.Tensor, mem: torch.Tensor):
    """K5: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (same signature as scan_step_plain)."""
    if llr.device.type == "cpu":
        return scan_step_plain(sched, llr, mem)
    _check("scan_step", sched, llr, mem)
    out = launch_step(_build.load("scan_sweep"), sched, llr, mem)
    LAUNCHES["step"] += 1
    return out
