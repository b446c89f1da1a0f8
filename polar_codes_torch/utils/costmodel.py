"""Operation and byte counts of one call of each codec, fixed by the work.

The port of polar_codes_tpu/utils/costmodel.py, with its names and
signatures. Each function returns {"flops", "bytes_accessed"} for one
call at `batch` codewords. The counts depend on the code (N, K, the
frozen set and its tree), the list size, the dtype, the detector and the
batch, and on nothing else: not on `kernel_span` or `chunk`, not on the
device, not on whether a kernel or its plain version runs. A roofline
read from them therefore stays a share of the same work whatever a later
implementation does.

Operations, per element, as the JAX package counts them (auditable, not
exact to the last instruction):

- f (min-sum) 4, g 2, combine (XOR) 1;
- a path fork gathers by index, 2 per output element (the JAX package's
  bitplane rule; K1 and the port's glue gather, they run no select chain);
- a leaf: 4 per position and path for the metric deltas, 2 per candidate
  and path, 4 per candidate, path and list slot for the extraction where
  the candidates outnumber the list, 2 per position and path out;
- Fast-SSC leaves 3 per position; a SCAN sweep 4 + 2 + 1 per position and
  stage; the encoder 1 per position and stage a pass (two systematic);
- a CRC: the syndrome of each path, 2 per position, path and tail bit; in
  the encoder 2 per info bit and tail bit.

Bytes are the least any implementation must move: each input read once
at its dtype, each output the call returns written once. A decode reads
its LLRs [B, N] (4 bytes in float32, 2 in bf16, 1 in int8) and writes its
info bits [B, K] and codeword [B, N] (uint8) and CRC flags [B] (bool); an
encode reads its info bits [B, K] and writes the codeword [B, N]. This is
chip_smoke.py's `bound` rule for one kernel, applied to a whole call. The
JAX package instead charges device-memory round trips to the levels that
XLA runs and boundary traffic to the Pallas subtrees, so its bytes change
with the route; the port has one route per device, and a count that moved
with it would let a faster kernel read above its roof.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.tree import NodeKind
from ..ops.scl_kernel_bl import n_candidates

_F, _G, _XOR = 4.0, 2.0, 1.0
_FORK = 2.0  # an index gather, per output element
# the chunk at which the JAX package's prune term counts its chunks (its
# LargeSCLDecoder default); fixed here, so the count does not move with chunk
_PRUNE_CHUNK = 256


def _stages(n_len: int) -> int:
    return int(np.log2(n_len))


def _decode_bytes(decoder, batch: int, llr_dtype=torch.float32) -> float:
    """LLRs [B, N] in; info [B, K], codeword [B, N] and flags [B] out."""
    n_len, k_len = decoder.block_length, decoder.info_length
    llr_bytes = torch.empty((), dtype=llr_dtype).element_size()
    return float(batch * (n_len * llr_bytes + k_len + n_len + 1))


def _leaf_candidates(node) -> int:
    """Candidates per path at a leaf: 1 for RATE0, which keeps its paths."""
    return max(n_candidates(node), 1)


def _tree_widths(decoder):
    """[(node, w_in, w_out)] of the decoder's tree in execution order: each
    fork multiplies the list width by its candidates, clamped at L."""
    out = []
    n_list = decoder.list_size

    def walk(node, w):
        if node.kind == NodeKind.BRANCH:
            w_out = walk(node.right, walk(node.left, w))
        else:
            cand = n_candidates(node)
            w_out = min(w * cand, n_list) if cand else w
        out.append((node, w, w_out))
        return w_out

    walk(decoder.tree, 1)
    return out


def scl_costs(decoder, batch: int) -> dict:
    """One decode() of SCLDecoder; at L = 1 the Fast-SSC decode it runs."""
    if decoder._sc is not None:
        return fastssc_costs(decoder._sc, batch)
    n_list, n_len = decoder.list_size, decoder.block_length
    flops = 0.0
    for node, w_in, w_out in _tree_widths(decoder):
        s = node.length
        if node.kind == NodeKind.BRANCH:
            half = s / 2
            flops += w_in * half * _F + w_out * half * (_G + _XOR)
            # the LLRs gathered after the left child, its bits after the right
            flops += _FORK * (w_out * s + w_out * half)
        else:
            cand = _leaf_candidates(node)
            flops += w_in * s * 4.0 + cand * w_in * 2.0
            if w_in * cand > n_list:
                flops += n_list * cand * w_in * 4.0
            flops += w_out * s * 2.0
    flops += 2.0 * n_list * n_len * decoder.detector.tail_bits
    flops += n_list * 4.0  # the best path's choice
    return {"flops": flops * batch,
            "bytes_accessed": _decode_bytes(decoder, batch, decoder.dtype)}


def fastssc_costs(decoder, batch: int) -> dict:
    """One decode() of FastSSCDecoder."""
    flops = 0.0

    def walk(node):
        nonlocal flops
        if node.kind == NodeKind.BRANCH:
            flops += node.length / 2 * (_F + _G + _XOR)
            walk(node.left)
            walk(node.right)
        else:
            flops += node.length * 3.0

    walk(decoder.tree)
    return {"flops": flops * batch,
            "bytes_accessed": _decode_bytes(decoder, batch, decoder.dtype)}


def encode_costs(encoder, batch: int) -> dict:
    """One encode() of PolarEncoder: info bits [B, K] in, codeword out."""
    n_len, k_len = encoder.block_length, encoder.info_length
    passes = 2 if encoder.systematic else 1
    flops = passes * n_len * _stages(n_len) * 1.0
    flops += 2.0 * k_len * encoder.detector.tail_bits
    return {"flops": flops * batch, "bytes_accessed": float(batch * (k_len + n_len))}


def scan_costs(decoder, batch: int) -> dict:
    """One decode() of ScanDecoder or FastSScanDecoder at its iterations."""
    n_len = decoder.block_length
    flops = decoder.iterations * n_len * _stages(n_len) * (_F + _G + 1.0)
    return {"flops": flops * batch, "bytes_accessed": _decode_bytes(decoder, batch)}


def large_costs(decoder, batch: int) -> dict:
    """One decode() of LargeSCDecoder or LargeSCLDecoder: the per-bit SC
    work of every path, and per chunk of _PRUNE_CHUNK the prune's."""
    n_len = decoder.block_length
    n_list = getattr(decoder, "list_size", 1)
    flops = n_list * n_len * _stages(n_len) * (_F + _G + _XOR)
    if n_list > 1:
        flops += max(n_len // _PRUNE_CHUNK, 1) * n_list * 8 * 4.0
    return {"flops": flops * batch,
            "bytes_accessed": _decode_bytes(decoder, batch, decoder.dtype)}
