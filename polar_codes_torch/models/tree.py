"""Code-tree specialization: classify the frozen set into a tree of node
kinds once, on the host.

A NumPy copy of polar_codes_tpu/models/tree.py. Decoders walk the tree in
Python; the kernels receive it flattened into a schedule
(ops/scl_kernel_bl.py, ops/fastssc_kernel.py, ops/scan_kernel.py).

Node kinds (Fast-SSC leaf set plus exhaustive-ML ENUM leaves):
  RATE0  all-frozen subcode
  RATE1  no-frozen subcode
  REP    repetition: only the last bit is information
  SPC    single parity check: only bit 0 is frozen
  ENUM   small mixed-rate subcode, decoded by enumerating its codewords
  BRANCH internal node (f -> left, g -> right, combine)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


class NodeKind(enum.Enum):
    RATE0 = "rate0"
    RATE1 = "rate1"
    REP = "rep"
    SPC = "spc"
    ENUM = "enum"
    BRANCH = "branch"


@dataclass(eq=False)
class CodeNode:
    """One subcode: offset/length locate its span in the codeword; frozen
    holds the node-local frozen positions (sorted, rebased)."""

    offset: int
    length: int
    frozen: np.ndarray
    kind: NodeKind
    left: Optional["CodeNode"] = None
    right: Optional["CodeNode"] = None

    @property
    def info_count(self) -> int:
        return self.length - len(self.frozen)

    def leaves(self) -> List["CodeNode"]:
        if self.kind != NodeKind.BRANCH:
            return [self]
        return self.left.leaves() + self.right.leaves()

    def node_count(self) -> int:
        if self.kind != NodeKind.BRANCH:
            return 1
        return 1 + self.left.node_count() + self.right.node_count()

    def describe(self, depth: int = 0) -> str:
        """The tree as indented text, one node a line: kind[start:end]."""
        pad = "  " * depth
        line = f"{pad}{self.kind.value}[{self.offset}:{self.offset + self.length}]"
        if self.kind != NodeKind.BRANCH:
            return line
        return "\n".join([line, self.left.describe(depth + 1), self.right.describe(depth + 1)])


ALL_LEAF_KINDS = frozenset(
    {NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC})


def classify(
    length: int,
    frozen: np.ndarray,
    allowed=ALL_LEAF_KINDS,
    enum_span: int = 0,
    max_enum_k: int = 0,
) -> NodeKind:
    """Leaf classification. `allowed` restricts the leaf kinds that end the
    recursion (SCAN collapses only RATE0 and RATE1 subtrees);
    enum_span/max_enum_k turn small mixed-rate subcodes into ENUM leaves."""
    n_frozen = len(frozen)
    if n_frozen == length and NodeKind.RATE0 in allowed:
        return NodeKind.RATE0
    if n_frozen == 0 and NodeKind.RATE1 in allowed:
        return NodeKind.RATE1
    if length == 1:  # span-1 nodes are rate-0 or rate-1 by definition
        return NodeKind.RATE0 if n_frozen else NodeKind.RATE1
    if (
        enum_span
        and length <= enum_span
        and 1 <= length - n_frozen <= max_enum_k
    ):
        return NodeKind.ENUM
    if (n_frozen == length - 1 and frozen[-1] == length - 2
            and NodeKind.REP in allowed):
        return NodeKind.REP
    if n_frozen == 1 and frozen[0] == 0 and NodeKind.SPC in allowed:
        return NodeKind.SPC
    return NodeKind.BRANCH


def build_tree(
    block_length: int,
    frozen_bit_positions: Sequence[int],
    offset: int = 0,
    allowed=ALL_LEAF_KINDS,
    enum_span: int = 0,
    max_enum_k: int = 0,
) -> CodeNode:
    """Recursively specialize the code defined by (N, frozen set);
    `allowed`, enum_span and max_enum_k as in classify."""
    frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
    kind = classify(block_length, frozen, allowed, enum_span, max_enum_k)
    node = CodeNode(offset=offset, length=block_length, frozen=frozen, kind=kind)
    if kind == NodeKind.BRANCH:
        half = block_length // 2
        node.left = build_tree(half, frozen[frozen < half], offset, allowed,
                               enum_span, max_enum_k)
        node.right = build_tree(half, frozen[frozen >= half] - half,
                                offset + half, allowed, enum_span, max_enum_k)
    return node
