"""The SCAN sweep kernels' CUDA source (csrc/scan_sweep.cu: K4 fused, K5
stepped), built for the CPU by ops/_emu.py (g++, one thread per CUDA
thread), against their plain versions `scan_fused_plain` and
`scan_step_plain`.

Small shapes, LLRs from a seed with numpy: Gaussian ones, and integers in
[-2, 2], which put signed zeros into f. Codes: Bhattacharyya at rate 1/2
for N = 4, 8, 64 and 256 (length-8 branch nodes run as subtree ops, the
others as F, G and COMBINE ops of 1 to 512 items); an N = 8 code whose
root has a rate-0 left and a rate-1 right child; and an N = 16 code whose
right half is frozen, so that +inf betas reach the node memory. Batches
1, 3 and 9 at 1, 2 and 1 codewords a warp and, where B > 1, 8 codewords a
block, so that blocks have idle warps and warps codewords past the batch;
K4 over 1 and 3 sweeps with its node memory on chip and in device
memory; K5 twice, the second time
on the memory of the first. Tolerance: none, betas and memory equal bit
for bit (+inf and the sign of zero included). The CPU runner orders
memory at every barrier and cannot show a race; on the card
`chip_smoke.py` holds the nvcc build to the same rules.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models.scan import ScanDecoder  # noqa: E402
from polar_codes_torch.models.tree import NodeKind  # noqa: E402
from polar_codes_torch.ops import _emu  # noqa: E402
from polar_codes_torch.ops import scan_kernel as sk  # noqa: E402

CODES = {
    "bb4": (4, lambda: frozen_bits(4, 2, 0.0)),
    "bb8": (8, lambda: frozen_bits(8, 4, 0.0)),
    "bb64": (64, lambda: frozen_bits(64, 32, 0.0)),
    "bb256": (256, lambda: frozen_bits(256, 128, 0.0)),
    "rate0_rate1": (8, lambda: [0, 1, 2, 3]),
    "inf_memory": (16, lambda: [0, 1, 2, 4] + list(range(8, 16))),
}
BATCHES = {1: 1, 3: 2, 9: 1}  # batch: codewords a warp


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the CPU build of a kernel needs it")
    return _emu.load_on_cpu("scan_sweep")


def _same(what, got, want):
    assert got.shape == want.shape, what
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), what


@pytest.mark.parametrize("n_batch", BATCHES)
@pytest.mark.parametrize("code", CODES)
def test_scan_source_on_cpu(lib, code, n_batch):
    n, frozen = CODES[code]
    sched = ScanDecoder(n, frozen(), device="cpu").sched
    if code == "rate0_rate1":
        assert (sched.tree.left.kind, sched.tree.right.kind) == (NodeKind.RATE0, NodeKind.RATE1)
    per_warp = BATCHES[n_batch]
    layout = {"per_warp": per_warp, "per_block": 8 // per_warp if n_batch > 1 else 0}
    rng = np.random.default_rng(n * 10 + n_batch)
    for kind in ("gauss", "ints"):
        if kind == "ints":
            x = torch.as_tensor(rng.integers(-2, 3, (n, n_batch)).astype(np.float32))
        else:
            x = torch.as_tensor((rng.standard_normal((n, n_batch)) * 1.5 + 0.5).astype(np.float32))
        where = f"{code} B={n_batch} at {per_warp} a warp, {kind}"
        for sweeps in (1, 3):
            want = sk.scan_fused_plain(sched, x, sweeps)
            for on_chip in (True, False):
                _same(f"{where}: K4 {sweeps} sweeps, memory on chip {on_chip}",
                      sk.launch_fused(lib, sched, x, sweeps, on_chip, **layout), want)
        mem = mem_plain = torch.zeros((sched.mem_rows, n_batch))
        for step in range(2):
            beta, mem = sk.launch_step(lib, sched, x, mem, **layout)
            beta_plain, mem_plain = sk.scan_step_plain(sched, x, mem_plain)
            _same(f"{where}: K5 step {step} betas", beta, beta_plain)
            _same(f"{where}: K5 step {step} memory", mem, mem_plain)
        if code == "inf_memory":
            assert torch.isinf(mem).any() and torch.isinf(beta).any()


def test_scan_source_zero_sweeps_and_limits(lib):
    """Zero sweeps give zero betas, as the plain version; a length the
    kernel does not take is refused (-1); a schedule whose state exceeds
    the card's shared memory per block raises NotImplementedError naming
    the limit."""
    sched = ScanDecoder(64, frozen_bits(64, 32, 0.0), device="cpu").sched
    x = torch.ones((64, 2))
    _same("zero sweeps", sk.launch_fused(lib, sched, x, 0, True), torch.zeros_like(x))
    fused, step = sk._bind(lib)
    assert fused(0, 0, 0, 0, 0, 0, 0, 8192, 1, 1, 0, 0, None) == -1
    assert step(0, 0, 0, 0, 0, 0, 0, 6, 1, 0, 0, None) == -1
    big = dataclasses.replace(sched, mem_rows=60000)
    with pytest.raises(NotImplementedError, match="232448"):
        sk.launch_fused(lib, big, x, 1, True)
