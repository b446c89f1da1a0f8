"""Carry the JAX package's code state into the port, and check it.

A polar code has no weights: its parameters are the frozen set, the info
positions, the decoder tree, the ENUM tables and the CRC's affine map. A
caller reads those off the JAX objects as numpy arrays and hands them to
`from_jax_state`, which builds the port's encoder and the decoder of the
named family from the frozen set and raises on the first array that the
port's own construction does not reproduce. So the carry checks that both
packages compute the same code; it is not a way around the port's
construction.

state keys:
    family        optional str: "scl" (default), "fastssc", "adaptive",
                  "scan", "fastsscan", "large_sc", "large_scl",
                  "depthfirst" or "errorlocator" (ErrorLocator in the
                  decoder's place)
    frozen        int array, the frozen positions
    info_pos      int array, the info positions
    systematic    bool
    detector      str, the detector's name ("crc16", "crc32", "dummy", ...)
    list_size     int                             (scl, adaptive, large_scl)
    enum_span     int, max_enum_k int                   (scl)
    dtype         optional str, "float32" (default), "int8" or "bfloat16":
                  the decoder's LLR family      (scl; large_sc and
                  large_scl take float32 or int8)
    fast_dtype    optional str, "float32", "int8" or "bfloat16"
                                                        (fastssc, adaptive)
    list_schedule optional int sequence                 (adaptive)
    iterations    optional int                          (scan, fastsscan)
    trial_limit   optional int (default 8)              (depthfirst)
    chunk         int, fast_chunks bool                 (large_sc, large_scl)
    subblock      optional int (None: no sub-blocks)    (large_scl)
    carry_dtype   optional str, "float32" or "bfloat16" (large_scl)
    schedule      optional str, "scan" (default) or "tree" (large_scl)
    mask_chunks   optional [T, chunk] bool, classes optional [T] int,
                  sub_classes optional [T, chunk / subblock] int: the
                  chunk masks and class codes      (large_sc, large_scl)
    affine_G      [tail, D] uint8, affine_map(D)[0]     (with a CRC)
    affine_g0     [tail] uint8, affine_map(D)[1]        (with a CRC)
    leaves        optional [n, 3] int: (kind index, offset, length) per
                  leaf of the decoder's tree (the Fast-SSC tree for
                  adaptive, the RATE0/RATE1 tree for SCAN, the RATE0-only
                  tree for depthfirst, the tree schedule's tree for
                  large_scl with schedule "tree"), kind index into NodeKind
                  order
    output_positions  optional int array with punctured_length int M: the
                  positions a Puncturer(M, frozen) keeps
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..models.adaptive import AdaptiveDecoder
from ..models.depthfirst import DepthFirstDecoder
from ..models.detectors import detector_by_name
from ..models.encoder import PolarEncoder
from ..models.errorlocator import ErrorLocator
from ..models.fastssc import FastSSCDecoder
from ..models.large import LargeSCDecoder, LargeSCLDecoder
from ..models.puncturer import Puncturer
from ..models.scan import FastSScanDecoder, ScanDecoder
from ..models.scl import SCLDecoder
from ..models.tree import NodeKind
from .device import DEFAULT_DEVICE

State = Dict[str, Union[np.ndarray, int, str, bool]]
_KINDS = list(NodeKind)


def leaf_table(tree) -> np.ndarray:
    """[n, 3] (kind index, offset, length) of the leaves in tree order."""
    return np.asarray(
        [[_KINDS.index(NodeKind(n.kind.value)), n.offset, n.length]
         for n in tree.leaves()], dtype=np.int64).reshape(-1, 3)


def _same(name: str, carried, ours) -> None:
    carried, ours = np.asarray(carried), np.asarray(ours)
    if carried.shape != ours.shape or not np.array_equal(carried, ours):
        raise ValueError(
            f"carried {name} differs from the port's construction: "
            f"{carried.tolist()} vs {ours.tolist()}")


_FAST_DTYPES = {"float32": torch.float32, "int8": torch.int8, "bfloat16": torch.bfloat16}
_CARRY_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPES = {"float32": torch.float32, "int8": torch.int8, "bfloat16": torch.bfloat16}


def _decoder(state: State, block_length: int, frozen: np.ndarray, detector,
             systematic: bool, device):
    family = str(state.get("family", "scl"))
    common = dict(systematic=systematic, detector=detector, device=device)
    fast_dtype = _FAST_DTYPES[str(state.get("fast_dtype", "float32"))]
    dtype = _DTYPES[str(state.get("dtype", "float32"))]
    if family == "scl":
        return SCLDecoder(
            block_length, frozen, list_size=int(state["list_size"]), dtype=dtype,
            enum_span=int(state["enum_span"]), max_enum_k=int(state["max_enum_k"]),
            **common)
    if family == "fastssc":
        return FastSSCDecoder(block_length, frozen, dtype=fast_dtype, **common)
    if family == "adaptive":
        schedule = state.get("list_schedule")
        return AdaptiveDecoder(
            block_length, frozen, list_size=int(state["list_size"]),
            fast_dtype=fast_dtype,
            list_schedule=None if schedule is None else tuple(int(l) for l in schedule),
            **common)
    if family in ("scan", "fastsscan"):
        cls = ScanDecoder if family == "scan" else FastSScanDecoder
        return cls(block_length, frozen, iterations=int(state.get("iterations", 1)),
                   **common)
    if family == "large_sc":
        return LargeSCDecoder(block_length, frozen, dtype=dtype, chunk=int(state["chunk"]),
                              fast_chunks=bool(state["fast_chunks"]), **common)
    if family == "large_scl":
        sub = state.get("subblock")
        carry = state.get("carry_dtype")
        return LargeSCLDecoder(
            block_length, frozen, list_size=int(state["list_size"]), dtype=dtype,
            chunk=int(state["chunk"]), fast_chunks=bool(state["fast_chunks"]),
            subblock=None if sub is None else int(sub),
            carry_dtype=None if carry is None else _CARRY_DTYPES[str(carry)],
            schedule=str(state.get("schedule", "scan")), **common)
    if family == "depthfirst":
        return DepthFirstDecoder(block_length, frozen,
                                 trial_limit=int(state.get("trial_limit", 8)), **common)
    if family == "errorlocator":
        return ErrorLocator(block_length, frozen, device=device)
    raise ValueError(f"unknown decoder family {family!r}")


def from_jax_state(state: State, device=DEFAULT_DEVICE) -> Tuple[PolarEncoder, object]:
    """Build (PolarEncoder, decoder of the state's family) from the carried
    state; raise ValueError on the first carried array the port does not
    reproduce."""
    frozen = np.asarray(state["frozen"], dtype=np.int64)
    info_pos = np.asarray(state["info_pos"], dtype=np.int64)
    block_length = frozen.size + info_pos.size
    detector = detector_by_name(str(state["detector"]))
    systematic = bool(state["systematic"])
    enc = PolarEncoder(block_length, frozen, systematic=systematic,
                       detector=detector, device=device)
    dec = _decoder(state, block_length, frozen, detector, systematic, device)
    _same("info_pos", info_pos, dec.info_pos)
    _same("encoder info_pos", info_pos, enc.info_pos)
    _same("frozen", np.sort(frozen), dec.frozen)
    if detector.tail_bits:
        G, g0 = detector.affine_map(dec.info_length - detector.tail_bits)
        _same("affine_G", state["affine_G"], G)
        _same("affine_g0", state["affine_g0"], g0)
    if "leaves" in state:
        tree = getattr(dec, "sched_tree", None) or dec.tree
        _same("leaves", state["leaves"], leaf_table(tree))
    if "output_positions" in state:
        _same("output_positions", state["output_positions"],
              Puncturer(int(state["punctured_length"]), frozen).output_positions)
    for name in ("mask_chunks", "classes", "sub_classes"):
        if name in state:
            _same(name, state[name], getattr(dec, name))
    return enc, dec
