"""Butterfly encoder kernel K2 (csrc/butterfly_encode.cu) and its plain
version.

Counterpart of polar_codes_tpu/ops/butterfly_kernel.py build_encode_kernel:
u-domain bits [B, N] (frozen positions 0) -> codeword bits [B, N], with
the systematic re-freeze and second pass. `butterfly_encode` runs the
plain version for tensors on the CPU and the CUDA kernel for tensors on
the card; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .butterfly import butterfly_transform

MAX_N = 2048  # a codeword's packed bits in at most one warp's registers
LAUNCHES = 0  # kernel launches since the count was last reset


def butterfly_encode_plain(u01: torch.Tensor, frozen_mask: torch.Tensor,
                           systematic: bool = True) -> torch.Tensor:
    """Plain version: transform, re-freeze, transform (as PolarEncoder.encode
    applies butterfly_transform), on uint8 bits."""
    code = butterfly_transform(u01)
    if systematic:
        code = code.masked_fill(frozen_mask.to(torch.bool), 0)
        code = butterfly_transform(code)
    return code


def _bind(lib):
    """The library's entry point, its types set on first use."""
    fn = lib.butterfly_encode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(lib, u01: torch.Tensor, frozen_mask: torch.Tensor, systematic: bool) -> torch.Tensor:
    """Launch K2 from the loaded library `lib` (the nvcc build, or the CPU
    build of ops/_emu.py on CPU tensors) on checked tensors."""
    fn = _bind(lib)
    dev = u01.device
    out = torch.empty_like(u01)
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    err = fn(u01.data_ptr(), frozen_mask.data_ptr(), out.data_ptr(), u01.shape[0],
             u01.shape[1], int(bool(systematic)), stream)
    if err:
        raise RuntimeError(f"butterfly_encode launch failed: CUDA error {err}")
    return out


def butterfly_encode(u01: torch.Tensor, frozen_mask: torch.Tensor,
                     systematic: bool = True) -> torch.Tensor:
    """u01 [B, N] uint8 u-domain bits, frozen_mask [N] uint8 -> [B, N] uint8."""
    if u01.device.type == "cpu":
        return butterfly_encode_plain(u01, frozen_mask, systematic)
    if u01.device.type != "cuda" or frozen_mask.device != u01.device:
        raise ValueError(
            f"butterfly_encode takes CPU or CUDA tensors on one device, got "
            f"{u01.device} and {frozen_mask.device}"
        )
    if u01.dtype != torch.uint8 or frozen_mask.dtype != torch.uint8:
        raise ValueError("butterfly_encode takes uint8 bits and a uint8 mask")
    if u01.dim() != 2 or not u01.is_contiguous() or not frozen_mask.is_contiguous():
        raise ValueError("butterfly_encode takes a contiguous [B, N] tensor")
    n_len = u01.shape[1]
    if n_len < 2 or n_len > MAX_N or n_len & (n_len - 1):
        raise NotImplementedError(
            f"the encode kernel covers power-of-2 N in [2, {MAX_N}], got {n_len}"
        )
    if frozen_mask.shape != (n_len,):
        raise ValueError(f"frozen mask must be [{n_len}]")
    out = launch(_build.load("butterfly_encode"), u01, frozen_mask, systematic)
    global LAUNCHES
    LAUNCHES += 1
    return out
