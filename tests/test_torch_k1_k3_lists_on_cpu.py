"""K1 at list sizes that are not a power of two or need more than one
packed word, and K3's bf16 family: their CUDA sources (csrc/scl_subtree.cu,
csrc/fastssc_subtree.cu) built for the CPU by ops/_emu.py (g++, one thread
per CUDA thread), against their plain versions.

K1: L = 3 (the capacity-4 instantiation with three live slots, a warp a
codeword) and L = 64 (two packed words, a block of 128 threads a
codeword, the prune a merge of lists), in all three families; L = 33, 100
and 128 (the block kernels, a warp split at tid = L below capacity) on
every leaf kind, a 16-candidate ENUM leaf and a subtree whose rate-0 leaf
precedes its rate-1 leaf; on the one-leaf schedules of the large-N
decoders, L = 1 (capacity 2) and L = 80 (three of capacity 128's four
words leave) (float32, char in int16, bf16); the merge on values that tie
across lists, in this kernel and in csrc/scl_wide.cu. Subtrees: one leaf
of each kind (rate-0, rate-1 at length 1 and longer, repetition, SPC,
ENUM) and the branched subtrees of an N = 64 code with every leaf kind and
of an N = 128 code at the SCL decoder's tree settings, each entered at
w_in = 1 (widening) and at w_in = L with every other row holding one live
path beside the inactive slots' -1e30. Inputs from a seed with numpy:
integer LLRs in [-2, 2] (ties, signed zeros through f and, for the block
kernels, in the input) with integer metrics, and Gaussian ones. Batches of
3, at 2 codewords a block in the warp kernels.

K3 bf16: codes whose trees hold every op and leaf kind in registers and in
shared memory (spans 2 to 2048), both output forms, Gaussian LLRs,
integers in [-2, 2] with zeros of either sign, and magnitudes 1e8 and 1
whose REP sums take another sign in another order; and a FastSSCDecoder
at N = 256, kernel_span 64, in bf16 through the CPU build.

Tolerance: none. Bits, perms and state equal, metrics equal bit for bit.
The CPU runner orders memory at every barrier and cannot show a race; on
the card `chip_smoke.py` holds the nvcc builds to the same rules.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.models.tree import ALL_LEAF_KINDS, CodeNode, NodeKind, build_tree  # noqa: E402
from polar_codes_torch.ops import _emu  # noqa: E402
from polar_codes_torch.ops import fastssc_kernel as fk  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402

DTYPES = {"float32": torch.float32, "char": torch.int16, "bfloat16": torch.bfloat16}
NEG = -1.0e30  # metric of an inactive list slot
ALL_KINDS_FROZEN = sorted(set(
    list(range(16)) + [16, 17, 18, 20, 24] + [32, 33, 34, 35, 36, 37, 38] + [48]))


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the CPU build of a kernel needs it")


@pytest.fixture(scope="module")
def k1():
    _need_gxx()
    lib = _emu.load_on_cpu("scl_subtree")
    return lib, kbl._bind(lib)


@pytest.fixture(scope="module")
def k3():
    _need_gxx()
    return _emu.load_on_cpu("fastssc_subtree")


# ---- K1 ---------------------------------------------------------------------

def _leaf(kind, span, frozen):
    return CodeNode(offset=0, length=span, frozen=np.asarray(frozen, np.int64), kind=kind)


def _nodes():
    frozen128 = np.sort(np.random.default_rng(128).choice(128, 64, replace=False))
    return [_leaf(NodeKind.RATE0, 8, range(8)), _leaf(NodeKind.RATE1, 1, []),
            _leaf(NodeKind.RATE1, 16, []), _leaf(NodeKind.REP, 8, range(7)),
            _leaf(NodeKind.SPC, 16, [0]), _leaf(NodeKind.ENUM, 8, [0, 1, 2, 4, 5]),
            build_tree(64, ALL_KINDS_FROZEN, allowed=ALL_LEAF_KINDS, enum_span=4,
                       max_enum_k=2),
            build_tree(128, frozen128, allowed=ALL_LEAF_KINDS, enum_span=16, max_enum_k=4)]


def _inputs(rng, sched, n_batch, dtype, kind):
    shape = (sched.w_in, sched.span, n_batch)
    if kind == "ints":
        llr = rng.integers(-2, 3, shape).astype(np.float32)
        met = rng.integers(-3, 1, (n_batch, sched.w_in)).astype(np.float32)
    else:
        llr = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
        if dtype == torch.int16:
            llr = np.clip(np.round(llr * 10.0), -127, 127)
        met = (rng.standard_normal((n_batch, sched.w_in)) * 3.0).astype(np.float32)
    if sched.w_in > 1:
        met[::2, 1:] = NEG  # every other row: one live path
    return torch.as_tensor(llr).to(dtype), torch.as_tensor(met)


def _run_k1(k1, sched, llr, met, per_block):
    lib, fn = k1
    fam = kbl.family(llr.dtype)
    assert kbl.shared_bytes(lib, sched, fam) > 0
    ops, masks, spc = sched.device_consts(torch.device("cpu"))
    n_batch = llr.shape[-1]
    words = kbl.n_words(sched.list_size)
    shape = (sched.span, n_batch) if words == 1 else (words, sched.span, n_batch)
    bits = torch.empty(shape, dtype=torch.int32)
    perm = torch.empty((n_batch, sched.w_out), dtype=torch.int32)
    m_out = torch.empty((n_batch, sched.w_out), dtype=torch.float32)
    assert fn(ops.data_ptr(), ops.shape[0], masks.data_ptr(), spc.data_ptr(), llr.data_ptr(),
              *llr.stride(),
              met.data_ptr(), bits.data_ptr(), perm.data_ptr(), m_out.data_ptr(),
              sched.list_size, sched.w_in, sched.w_out, sched.span, n_batch, fam.code,
              per_block, None) == 0
    return bits, perm, m_out


@pytest.mark.parametrize("n_list", [3, 6, 12, 24, 64])
@pytest.mark.parametrize("family", DTYPES)
def test_k1_source_on_cpu_any_list(k1, family, n_list):
    rng = np.random.default_rng(n_list + len(family))
    dtype = DTYPES[family]
    widths = set()
    for node in _nodes():
        for w_in in (1, n_list):
            sched = kbl.build_schedule(node, w_in, n_list)
            widths.add(sched.w_out)
            for kind in ("ints", "gauss"):
                llr, met = _inputs(rng, sched, 3, dtype, kind)
                got = _run_k1(k1, sched, llr, met, 2)
                want = kbl.scl_subtree_plain(sched, llr, met)
                where = f"L {n_list} {node.kind.value} span {node.length}, w_in {w_in}, {kind}"
                assert got[0].shape == want[0].shape, where
                assert torch.equal(got[0], want[0]), where + ": bits"
                assert torch.equal(got[1], want[1]), where + ": perm"
                assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), (
                    where + ": metrics")
    assert n_list in widths and any(1 < w < n_list for w in widths)


@pytest.mark.parametrize("n_list,family", [(1, "float32"), (1, "char"), (1, "bfloat16"),
                                            (80, "float32")])
def test_k1_source_on_cpu_one_leaf_any_list(k1, n_list, family):
    """The one-leaf schedules the large-N decoders build (w_in = L): at
    L = 1 in capacity 2's kernel, and at L = 80, whose three words a
    position (capacity 128 holds four) are all that leave the kernel."""
    rng = np.random.default_rng(n_list + len(family))
    dtype = DTYPES[family]
    for node in _nodes()[:6]:
        sched = kbl.build_schedule(node, n_list, n_list)
        for kind in ("ints", "gauss"):
            llr, met = _inputs(rng, sched, 3, dtype, kind)
            got = _run_k1(k1, sched, llr, met, 2)
            want = kbl.scl_subtree_plain(sched, llr, met)
            where = f"L {n_list} {node.kind.value} span {node.length}, {kind}"
            assert got[0].shape == want[0].shape, where
            assert torch.equal(got[0], want[0]), where + ": bits"
            assert torch.equal(got[1], want[1]), where + ": perm"
            assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), (
                where + ": metrics")


@pytest.mark.parametrize("n_list,family", [(1, "float32"), (1, "char"), (1, "bfloat16"),
                                            (64, "float32")])
def test_k1_source_on_cpu_one_leaf_views(k1, n_list, family):
    """The one-leaf schedules the large-N decoders build (w_in = L), every
    leaf kind, fed the glue's [L, S, B] view of a batch-first [B, L, S]
    tensor and a contiguous copy of it: the kernel reads the view at its
    strides (L = 1 in the one-path instantiation, 64 in capacity 64's
    block); both equal the plain version."""
    rng = np.random.default_rng(5 * n_list + len(family))
    dtype = DTYPES[family]
    for node in _nodes()[:6]:
        sched = kbl.build_schedule(node, n_list, n_list)
        llr, met = _inputs(rng, sched, 3, dtype, "ints")
        view = llr.permute(2, 0, 1).contiguous().permute(1, 2, 0)
        want = kbl.scl_subtree_plain(sched, view, met)
        for x in (view, view.contiguous()):
            got = _run_k1(k1, sched, x, met, 0)
            where = f"L {n_list} {node.kind.value} span {node.length}, {x.stride()}"
            assert torch.equal(got[0], want[0]), where + ": bits"
            assert torch.equal(got[1], want[1]), where + ": perm"
            assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), (
                where + ": metrics")


def _block_nodes():
    """One leaf of each kind, a 16-candidate ENUM leaf among them, and a
    span-32 subtree whose rate-0 half comes before its rate-1 half (the
    rate-1 prune then meets lists out of rank order)."""
    return _nodes()[:6] + [_leaf(NodeKind.ENUM, 16, [0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 13]),
                           build_tree(32, range(16))]


def _signed_zeros(rng, llr):
    """Zeros of either sign in a float LLR tensor."""
    x = llr.to(torch.float32).numpy().copy()
    zero = x == 0
    x[zero] = rng.choice(np.float32([-0.0, 0.0]), int(zero.sum()))
    return torch.as_tensor(x).to(llr.dtype)


@pytest.mark.parametrize("n_list,family", [(33, "float32"), (100, "char"), (128, "bfloat16")])
def test_k1_block_source_on_cpu(k1, n_list, family):
    """Capacities 64 and 128 run a block of 2 x capacity threads a codeword
    and prune by merging lists: at L = 33 and 100 the warp that holds path
    L - 1 reaches each barrier split at tid = L (the CPU runner cannot show
    a lost barrier phase; chip_smoke.py phase 36 does), at 128 every thread
    holds a candidate of a two-way fork. Every leaf kind, entered at one
    path and at L with every other row holding one live path; integer LLRs
    in [-2, 2] with zeros of either sign, and Gaussian ones."""
    rng = np.random.default_rng(7 * n_list + len(family))
    dtype = DTYPES[family]
    for node in _block_nodes():
        for w_in in (1, n_list):
            sched = kbl.build_schedule(node, w_in, n_list)
            for kind in ("ints", "gauss"):
                llr, met = _inputs(rng, sched, 3, dtype, kind)
                if kind == "ints" and dtype != torch.int16:
                    llr = _signed_zeros(rng, llr)
                got = _run_k1(k1, sched, llr, met, 0)
                want = kbl.scl_subtree_plain(sched, llr, met)
                where = f"L {n_list} {node.kind.value} span {node.length}, w_in {w_in}, {kind}"
                assert got[0].shape == want[0].shape, where
                assert torch.equal(got[0], want[0]), where + ": bits"
                assert torch.equal(got[1], want[1]), where + ": perm"
                assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), (
                    where + ": metrics")


@pytest.mark.parametrize("source,n_list", [("scl_subtree", 64), ("scl_wide", 129)])
def test_k1_merge_ranks_ties_across_lists(k1, source, n_list):
    """The prune by merge on values that tie across lists: metrics in rank
    order with runs of equal integers (the keep list taken as it is), LLRs
    in {-1, -0.0, +0.0, 1}, so that a flip (l, c > 0) costing |x| = 1 or 0
    ties a keep of another path (l', 0) or its own; the flip lists out of
    rank order, ranked in runs of 32 and merged. Rate-1 leaves of span 1
    and 16, a REP and an SPC leaf, entered at L; the second row holds a
    -1e30 tail. The shared-memory kernel at L = 64 and the device-memory
    kernel (csrc/scl_wide.cu) at L = 129, against the plain version."""
    rng = np.random.default_rng(n_list)
    lib = k1[0] if source == "scl_subtree" else _emu.load_on_cpu("scl_wide")
    for node in (_leaf(NodeKind.RATE1, 1, []), _leaf(NodeKind.RATE1, 16, []),
                 _leaf(NodeKind.REP, 8, range(7)), _leaf(NodeKind.SPC, 16, [0])):
        sched = kbl.build_schedule(node, n_list, n_list)
        met = -np.floor(np.arange(n_list) / 4.0).astype(np.float32)[None].repeat(2, 0)
        met[1, n_list // 2:] = NEG
        llr = rng.choice(np.float32([-1.0, -0.0, 0.0, 1.0]), (n_list, node.length, 2))
        llr, met = torch.as_tensor(llr), torch.as_tensor(met)
        if source == "scl_subtree":
            got = _run_k1(k1, sched, llr, met, 0)
        else:
            assert kbl.shared_bytes(k1[0], sched, kbl.family(llr.dtype)) < 0
            got = kbl.launch_wide(lib, sched, llr, met)
        want = kbl.scl_subtree_plain(sched, llr, met)
        where = f"{source} L {n_list} {node.kind.value} span {node.length}"
        assert torch.equal(got[0], want[0]), where + ": bits"
        assert torch.equal(got[1], want[1]), where + ": perm"
        assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), (
            where + ": metrics")


def _prune_rows(rng, w_in, span):
    """Four rows of LLRs [w_in, span, 4] and metrics [4, w_in] for a leaf's
    prune: every candidate 0 (LLRs and metrics of either zero's sign), so
    code order alone decides and the threshold's key is shared on both
    sides of slot L; integer metrics in runs of three with LLRs in {-1,
    -0.0, +0.0, 1}, so that values tie across paths at the threshold; one
    live path beside -1e30; Gaussian values."""
    llr = np.empty((w_in, span, 4), np.float32)
    met = np.zeros((4, w_in), np.float32)
    llr[..., 0] = rng.choice(np.float32([-0.0, 0.0]), (w_in, span))
    met[0] = rng.choice(np.float32([-0.0, 0.0]), w_in)
    llr[..., 1] = rng.choice(np.float32([-1.0, -0.0, 0.0, 1.0]), (w_in, span))
    met[1] = -np.floor(np.arange(w_in) / 3.0)
    llr[..., 2] = rng.standard_normal((w_in, span))
    met[2, 1:] = NEG
    llr[..., 3] = rng.standard_normal((w_in, span)) * 2.0 + 0.5
    met[3] = rng.standard_normal(w_in) * 3.0
    return llr, met


@pytest.mark.parametrize("n_list", [6, 12, 24, 32])
def test_k1_warp_prune_select_on_cpu(k1, n_list):
    """The warp teams' prune: up to 64 candidates a lane ranks them against
    all T, above 64 a threshold select (warp counts find the L-th largest
    key, ties at it taken in code order, the survivors ranked among
    themselves). REP (2 candidates a path), SPC (8) and ENUM (16) leaves
    entered at the fewest paths that give T > L, at the fewest that give T
    > 64 and at L (T = 16 L at most), in float32 and bf16, on the rows of
    _prune_rows; bits, perms and metrics equal to the plain version."""
    rng = np.random.default_rng(31 * n_list)
    selects = 0
    for node in (_leaf(NodeKind.REP, 8, range(7)), _leaf(NodeKind.SPC, 16, [0]),
                 _leaf(NodeKind.ENUM, 16, [0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 13])):
        nc = kbl.n_candidates(node)
        for w_in in sorted({-(-(n_list + 1) // nc), -(-65 // nc), n_list}):
            if w_in > n_list:
                continue
            selects += w_in * nc > 64
            llr, met = _prune_rows(rng, w_in, node.length)
            sched = kbl.build_schedule(node, w_in, n_list)
            for dtype in (torch.float32, torch.bfloat16):
                x, m = torch.as_tensor(llr).to(dtype), torch.as_tensor(met)
                got = _run_k1(k1, sched, x, m, 2)
                want = kbl.scl_subtree_plain(sched, x, m)
                where = f"L {n_list} {node.kind.value} w_in {w_in} (T {w_in * nc}), {dtype}"
                assert torch.equal(got[0], want[0]), where + ": bits"
                assert torch.equal(got[1], want[1]), where + ": perm"
                assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), (
                    where + ": metrics")
    assert selects >= 2


def test_k1_list_capacity_and_smem(k1):
    """A list size takes the next power of two's state (L = 1 the one-path
    instantiation's, smaller than capacity 2's); L = 64 and 128 fit the card's shared memory at the JAX package's
    default span (128); a list beyond the shared-memory kernel's largest,
    and a branched span of 512 at L = 128, go to the device-memory kernel
    (csrc/scl_wide.cu), whose plan keeps only the levels in device
    memory there."""
    lib, fn = k1
    f32 = kbl.family(torch.float32).code
    assert lib.scl_subtree_smem(3, 512, f32, 3) == lib.scl_subtree_smem(4, 512, f32, 3)
    assert lib.scl_subtree_smem(40, 128, f32, 3) == lib.scl_subtree_smem(64, 128, f32, 3)
    assert lib.scl_subtree_smem(64, 128, f32, 3) < 50 * 1024  # 32 KiB of levels, the rest lists
    assert lib.scl_subtree_smem(128, 128, f32, 3) < 100 * 1024
    assert lib.scl_subtree_smem(kbl.MAX_LIST + 1, 128, f32, 3) == -1
    assert 0 < lib.scl_subtree_smem(1, 128, f32, 3) < lib.scl_subtree_smem(2, 128, f32, 3)
    assert lib.scl_subtree_smem(0, 128, f32, 3) == -1
    fam = kbl.family(torch.float32)
    node = build_tree(512, range(256))
    assert kbl.shared_bytes(lib, kbl.build_schedule(node, 128, 128), fam) == -1
    assert kbl.shared_bytes(lib, kbl.build_schedule(node, 128, 64), fam) > 0
    assert kbl.shared_bytes(lib, kbl.build_schedule(build_tree(128, range(64)), 129, 129),
                            fam) == -1
    wide = _emu.load_on_cpu("scl_wide")
    smem, scratch = kbl.wide_plan(wide, 128, 512, 10, 8, fam.code)
    assert scratch == 128 * 511 * 4 and smem < 96 * 1024


# ---- K3 bf16 ----------------------------------------------------------------

CODES = {
    "bb8": (8, lambda: frozen_bits(8, 4, 0.0)),
    "bb256": (256, lambda: frozen_bits(256, 128, 0.0)),
    "long_leaves": (256, lambda: list(range(63)) + [64] + list(range(128, 224))),
    "rate1_rate0": (128, lambda: list(range(64, 128))),
    "spc_rate0": (8, lambda: [0, 4, 5, 6, 7]),
    "branch2": (2, lambda: [1]),
    "wide_leaves": (512, lambda: list(range(128, 511))),
    "bb2048": (2048, lambda: frozen_bits(2048, 1024, 0.0)),
    "zero_r2048": (2048, lambda: list(range(1024)) + [1024 + int(i) for i in
                                                      frozen_bits(1024, 512, 0.0)]),
    "rep2048": (2048, lambda: list(range(2047))),
    "spc2048": (2048, lambda: [0]),
    "rate1_2048": (2048, lambda: []),
}


def _kinds(sched):
    names = ["F", "G", "ZERO_R", "COMBINE"]
    leaves = ["RATE0", "RATE1", "REP", "SPC"]
    return {("registers" if length <= 1024 else "shared",
             leaves[kind] if op == fk.OP_LEAF else names[op])
            for op, _, length, _, kind in sched.ops.tolist()}


def _bf16_llrs(rng, span, n_batch):
    ints = rng.integers(-2, 3, (span, n_batch)).astype(np.float32)
    ints[ints == 0] *= rng.choice([-1.0, 1.0], int((ints == 0).sum()))  # -0.0 and +0.0
    gauss = (rng.standard_normal((span, n_batch)) * 2.0 + 0.5).astype(np.float32)
    order = rng.choice(np.float32([1e8, -1e8, 1.0, -0.5, 0.25, -3.0]), (span, n_batch))
    order[:, 0] = np.resize(np.float32([1e8, 1.0, -1e8, -0.5]), span)  # -0.5 in order
    return {name: torch.as_tensor(x).to(torch.bfloat16)
            for name, x in (("ints", ints), ("gauss", gauss), ("order", order))}


def test_k3_bf16_codes_hold_every_op_kind():
    seen = set()
    for span, frozen in CODES.values():
        seen |= _kinds(fk.build_schedule(build_tree(span, frozen())))
    for where in ("registers", "shared"):
        for kind in ("F", "G", "ZERO_R", "COMBINE", "RATE1", "REP", "SPC"):
            assert (where, kind) in seen, (where, kind)
    assert ("registers", "RATE0") in seen


@pytest.mark.parametrize("code", CODES)
def test_k3_bf16_source_on_cpu(k3, code):
    span, frozen = CODES[code]
    sched = fk.build_schedule(build_tree(span, frozen()))
    rng = np.random.default_rng(span + len(code))
    for n_batch in (1, 9) if span <= 512 else (3,):
        for kind, llr in _bf16_llrs(rng, span, n_batch).items():
            for root in (True, False):
                got = fk.launch(k3, sched, llr, root)
                want = fk.fastssc_subtree_plain(sched, llr, root)
                where = f"{code} B={n_batch} {kind} root={root}"
                assert got.dtype == want.dtype and got.shape == want.shape, where
                assert torch.equal(got, want), where


def test_k3_bf16_decoder_on_cpu_build(k3):
    """FastSSCDecoder(bf16) at N = 256 with kernel_span 64: the bf16 glue
    above and K3's CPU build on every subtree decide as the plain version."""
    n = 256
    frozen = frozen_bits(n, 128, 0.0)
    calls = []

    def on_cpu_build(sched, llr, root):
        calls.append(llr.dtype)
        return fk.launch(k3, sched, llr, root)

    dec = FastSSCDecoder(n, frozen, dtype=torch.bfloat16, kernel_span=64, device="cpu",
                         subtree_fn=on_cpu_build)
    plain = FastSSCDecoder(n, frozen, dtype=torch.bfloat16, kernel_span=64, device="cpu",
                           subtree_fn=fk.fastssc_subtree_plain)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((9, n)) * 2.0 + 1.0)
    assert torch.equal(dec.decode_to_codeword(x), plain.decode_to_codeword(x))
    assert len(calls) >= 2 and set(calls) == {torch.bfloat16}
