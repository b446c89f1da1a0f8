"""The SCL subtree kernel's CUDA source (csrc/scl_subtree.cu, K1), built for
the CPU by ops/_emu.py (g++, one thread per CUDA thread), against its plain
version `scl_subtree_plain`, in all three families (float32, char in
int16, bf16).

Small shapes, inputs from a seed with numpy: integer LLRs in [-2, 2] (ties,
signed zeros through f) with integer metrics, and Gaussian ones; list sizes
2, 8 and 32; each subtree entered at w_in = 1 (widening) and at w_in = L.
Subtrees: one leaf of each kind (rate-0, rate-1 at length 1 and longer,
repetition, SPC, ENUM), one-leaf span-256 schedules of the four kinds a
large-N pure chunk takes (entered at w_in = L as there, every other row
with one live path beside the inactive slots' -1e30), and the branched
subtrees of an N = 64 code with every leaf kind and of an N = 128 code at
the SCL decoder's tree settings. Batches of 5 and 3 at 4 codewords per
block leave a block part empty. Tolerance: none. Bits and perms equal, metrics equal bit for bit in
every family (float32 too: the kernel sums in the plain version's order
and is built without FMA contraction). On the card `chip_smoke.py` holds
the nvcc build to the same rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_torch.models.tree import ALL_LEAF_KINDS, CodeNode, NodeKind, build_tree  # noqa: E402
from polar_codes_torch.ops import _emu  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402

DTYPES = {"float32": torch.float32, "char": torch.int16, "bfloat16": torch.bfloat16}
LISTS = (2, 8, 32)
NEG = -1.0e30  # metric of an inactive list slot (models/large.py)
# every leaf kind below span 32 (tests/test_scl_pallas.py test_all_leaf_kinds)
ALL_KINDS_FROZEN = sorted(set(
    list(range(16)) + [16, 17, 18, 20, 24] + [32, 33, 34, 35, 36, 37, 38] + [48]))


@pytest.fixture(scope="module")
def k1():
    try:
        lib = _emu.load_on_cpu("scl_subtree")
    except RuntimeError as err:  # no g++ on this machine
        pytest.skip(str(err))
    return lib, kbl._bind(lib)


def _leaf(kind, span, frozen):
    return CodeNode(offset=0, length=span, frozen=np.asarray(frozen, np.int64), kind=kind)


def _leaves():
    """One leaf of each kind."""
    return [_leaf(NodeKind.RATE0, 8, range(8)), _leaf(NodeKind.RATE1, 1, []),
            _leaf(NodeKind.RATE1, 16, []), _leaf(NodeKind.REP, 8, range(7)),
            _leaf(NodeKind.SPC, 16, [0]), _leaf(NodeKind.ENUM, 8, [0, 1, 2, 4, 5])]


def _chunk_leaves():
    """The one-leaf span-256 schedules of a large-N decoder's pure chunks."""
    return [_leaf(NodeKind.RATE0, 256, range(256)), _leaf(NodeKind.RATE1, 256, []),
            _leaf(NodeKind.REP, 256, range(255)), _leaf(NodeKind.SPC, 256, [0])]


def _codes():
    """Branched subtrees: an N = 64 code with every leaf kind (ENUM span 4,
    k 2, which keeps a repetition leaf), and an N = 128 code at the SCL
    decoder's defaults (ENUM span 16, k 4)."""
    frozen128 = np.sort(np.random.default_rng(128).choice(128, 64, replace=False))
    return [build_tree(64, ALL_KINDS_FROZEN, allowed=ALL_LEAF_KINDS, enum_span=4,
                       max_enum_k=2),
            build_tree(128, frozen128, allowed=ALL_LEAF_KINDS, enum_span=16, max_enum_k=4)]


def _inputs(rng, sched, n_batch, dtype, kind, live_one=False):
    shape = (sched.w_in, sched.span, n_batch)
    if kind == "ints":
        llr = rng.integers(-2, 3, shape).astype(np.float32)
        met = rng.integers(-3, 1, (n_batch, sched.w_in)).astype(np.float32)
    else:
        llr = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
        if dtype == torch.int16:
            llr = np.clip(np.round(llr * 10.0), -127, 127)
        met = (rng.standard_normal((n_batch, sched.w_in)) * 3.0).astype(np.float32)
    if live_one and sched.w_in > 1:
        met[::2, 1:] = NEG  # every other row: one live path
    return torch.as_tensor(llr).to(dtype), torch.as_tensor(met)


def _run(k1, sched, llr, met, per_block):
    lib, fn = k1
    fam = kbl.family(llr.dtype)
    assert kbl.shared_bytes(lib, sched, fam) > 0
    ops, masks, spc = sched.device_consts(torch.device("cpu"))
    n_batch = llr.shape[-1]
    bits = torch.empty((sched.span, n_batch), dtype=torch.int32)
    perm = torch.empty((n_batch, sched.w_out), dtype=torch.int32)
    m_out = torch.empty((n_batch, sched.w_out), dtype=torch.float32)
    assert fn(ops.data_ptr(), ops.shape[0], masks.data_ptr(), spc.data_ptr(), llr.data_ptr(),
              *llr.stride(),
              met.data_ptr(), bits.data_ptr(), perm.data_ptr(), m_out.data_ptr(),
              sched.list_size, sched.w_in, sched.w_out, sched.span, n_batch, fam.code,
              per_block, None) == 0
    return bits, perm, m_out


def _glue_view(llr):
    """The same values as the large-N glue hands them over: an [L, S, B] view
    of a batch-first [B, L, S] tensor."""
    return llr.permute(2, 0, 1).contiguous().permute(1, 2, 0)


def _check(k1, nodes, family, n_list, n_batch, per_block, seed, live_one=False,
           widths=(1, None), view=False):
    rng = np.random.default_rng(seed)
    dtype = DTYPES[family]
    for node in nodes:
        for w_in in (w or n_list for w in widths):
            sched = kbl.build_schedule(node, w_in, n_list)
            for kind in ("ints", "gauss"):
                llr, met = _inputs(rng, sched, n_batch, dtype, kind, live_one)
                if view:
                    llr = _glue_view(llr)
                got = _run(k1, sched, llr, met, per_block)
                want = kbl.scl_subtree_plain(sched, llr, met)
                where = f"{node.kind.value} span {node.length}, w_in {w_in}, {kind}"
                assert torch.equal(got[0], want[0]), where + ": bits"
                assert torch.equal(got[1], want[1]), where + ": perm"
                assert torch.equal(got[2].view(torch.int32),
                                   want[2].view(torch.int32)), where + ": metrics"


@pytest.mark.parametrize("n_list", LISTS)
@pytest.mark.parametrize("family", DTYPES)
def test_k1_source_on_cpu_leaves(k1, family, n_list):
    _check(k1, _leaves(), family, n_list, 5, 4, seed=n_list + len(family))


@pytest.mark.parametrize("n_list", LISTS)
@pytest.mark.parametrize("family", DTYPES)
def test_k1_source_on_cpu_one_leaf_span256(k1, family, n_list):
    _check(k1, _chunk_leaves(), family, n_list, 2, 0, seed=10 * n_list + len(family),
           live_one=True, widths=(None,))


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("family", DTYPES)
def test_k1_source_on_cpu_one_path(k1, family, view):
    """The one-path instantiation (L = 1): the one-leaf span-256 schedules
    of a large-N decoder's pure chunks, a leaf of each kind (ENUM too) and
    the branched subtrees, fed a contiguous [1, S, B] tensor or the glue's
    view of a batch-first [B, 1, S] one (read in place at its strides)."""
    _check(k1, _chunk_leaves() + _leaves(), family, 1, 3, 0, seed=3 + len(family),
           widths=(None,), view=view)
    if not view:
        _check(k1, _codes(), family, 1, 3, 4, seed=4 + len(family), widths=(None,))


def _long_leaves(span):
    """One leaf of each kind a large-N tree schedule walks, at `span`."""
    return [_leaf(NodeKind.RATE0, span, range(span)), _leaf(NodeKind.RATE1, span, []),
            _leaf(NodeKind.REP, span, range(span - 1)), _leaf(NodeKind.SPC, span, [0])]


@pytest.mark.parametrize("family", DTYPES)
def test_k1_source_on_cpu_one_leaf_long(k1, family):
    """One-leaf schedules of every kind entered at w_in = L, at L = 8, span
    512 and L = 16, span 1024 (staged into shared memory) and at L = 32,
    span 2048 in float32 and 4096 in int16 and bf16, whose input does not
    fit there (read from device memory); integer and Gaussian inputs by
    turns, every other row with one live path."""
    lib, fn = k1
    dtype = DTYPES[family]
    code = kbl.family(dtype).code
    long_span = 2048 if dtype == torch.float32 else 4096
    rng = np.random.default_rng(len(family))
    for n_list, span in ((8, 512), (16, 1024), (32, long_span)):
        staged = n_list * span * dtype.itemsize
        assert (lib.scl_subtree_smem(n_list, span, code, 1) < staged) == (n_list == 32)
        for i, node in enumerate(_long_leaves(span)):
            sched = kbl.build_schedule(node, n_list, n_list)
            kind = ("ints", "gauss")[(i + n_list) % 2]
            llr, met = _inputs(rng, sched, 2, dtype, kind, live_one=True)
            got = _run(k1, sched, llr, met, 2)
            want = kbl.scl_subtree_plain(sched, llr, met)
            where = f"{node.kind.value} span {span}, L {n_list}, {kind}"
            assert torch.equal(got[0], want[0]), where + ": bits"
            assert torch.equal(got[1], want[1]), where + ": perm"
            assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), where


@pytest.mark.parametrize("n_list", LISTS)
@pytest.mark.parametrize("family", DTYPES)
def test_k1_source_on_cpu_branched(k1, family, n_list):
    _check(k1, _codes(), family, n_list, 3, 4, seed=100 * n_list + len(family))
    kinds = {leaf.kind for node in _codes() for leaf in node.leaves()}
    assert kinds == set(NodeKind) - {NodeKind.BRANCH}


def test_k1_refuses_state_beyond_shared_memory(k1):
    """A branched span whose list state cannot fit one block's shared
    memory is refused by the shared-memory kernel's launch, and the
    wrapper's check sends it to the device-memory kernel (csrc/scl_wide.cu);
    a one-leaf schedule of that span reads device memory in the
    shared-memory kernel instead."""
    lib, fn = k1
    node = build_tree(8192, range(4096))
    assert node.kind == NodeKind.BRANCH
    sched = kbl.build_schedule(node, 8, 8)
    assert lib.scl_subtree_smem(8, 8192, 0, sched.ops.shape[0]) > 232448
    assert kbl.shared_bytes(lib, sched, kbl.family(torch.float32)) == -1
    assert lib.scl_subtree_smem(8, 512, 0, 3) <= 20480  # the default span fits ~10 a SM
    leaf = kbl.build_schedule(_leaf(NodeKind.RATE1, 8192, []), 8, 8)
    assert 0 < kbl.shared_bytes(lib, leaf, kbl.family(torch.float32)) < 48 * 1024
    ops, masks, spc = sched.device_consts(torch.device("cpu"))
    llr = torch.zeros((8, 8192, 1))
    met = torch.zeros((1, 8))
    out = torch.empty(8192, dtype=torch.int32)
    assert fn(ops.data_ptr(), ops.shape[0], masks.data_ptr(), spc.data_ptr(), llr.data_ptr(),
              *llr.stride(),
              met.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(), 8, 8, 8,
              8192, 1, 0, 0, None) == -2
