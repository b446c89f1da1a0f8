"""The Fast-SSC subtree kernel's CUDA source (csrc/fastssc_subtree.cu, K3)
and the butterfly encoder's (csrc/butterfly_encode.cu, K2), built for the
CPU by ops/_emu.py (g++, one thread per CUDA thread), against their plain
versions `fastssc_subtree_plain` and `butterfly_encode_plain`.

K3: both families (float32, char on int8 LLRs), both output forms (root
bits, bipolar state below the glue), spans 2 to 2048. Codes: Bhattacharyya
at rate 1/2 of every length from 4 to 256 and of 2048, and hand-made ones
whose trees hold what those lack: leaves of 32 to 256 positions of every
kind (REP, SPC, rate-1, rate-0 as a right child), ZeroR on nodes of 64,
128 and 2048, a rate-0 right leaf of 4, one-leaf subtrees up to 2048, and
the branch of length 2. Together they hold every op and leaf kind both in
registers and in shared memory (`_kinds` checks that). Inputs from a seed
with numpy: Gaussian LLRs; integers in [-2, 2] (REP sums of exactly 0, SPC
magnitude ties, and in float32 zeros of either sign); in float32 also
values of magnitudes 1e8 and 1, whose REP sums round to another sign in
another order; in char also -128 and +-127. Batches 1 and 9 (the second
block of 8 codewords holds one codeword and seven idle warps; 1 and 3 at
span 2048). Decoders: FastSSCDecoder at N = 256 with
kernel_span 64 runs K3's CPU build on every subtree, root and bipolar.

K2: N in {2, 4, 32, 64, 256, 1024, 2048}, systematic or not, B = 1 and 3
(at N = 64 a warp holds 16 codewords, so lanes lie past the batch), on
random {0, 1} bits including the frozen positions, with a code's frozen
mask and a random one, and once from a buffer that is not 16-byte aligned
(byte-by-byte loads and stores).

Tolerance: none; bits and state equal exactly. The CPU runner orders
memory at every barrier and cannot show a race; on the card
`chip_smoke.py` holds the nvcc builds to the same rules.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.models.tree import build_tree  # noqa: E402
from polar_codes_torch.ops import _emu  # noqa: E402
from polar_codes_torch.ops import butterfly_kernel as bk  # noqa: E402
from polar_codes_torch.ops import fastssc_kernel as fk  # noqa: E402

# span: frozen positions
CODES = {
    **{f"bb{n}": (n, lambda n=n: frozen_bits(n, n // 2, 0.0)) for n in (4, 8, 16, 32, 64, 128, 256)},
    # REP 64 | SPC 64 || ZeroR 128: (ZeroR 64: rate-1 32)
    "long_leaves": (256, lambda: list(range(63)) + [64] + list(range(128, 224))),
    # rate-1 64 | rate-0 64 (a right leaf of 64)
    "rate1_rate0": (128, lambda: list(range(64, 128))),
    # SPC 4 | rate-0 4 (a right leaf in registers)
    "spc_rate0": (8, lambda: [0, 4, 5, 6, 7]),
    # rate-1 1 | rate-0 1
    "branch2": (2, lambda: [1]),
    # rate-1 128 | rate-0 128 || REP 256: leaves above the register subtrees
    "wide_leaves": (512, lambda: list(range(128, 511))),
    "rep64": (64, lambda: list(range(63))),
    "spc128": (128, lambda: [0]),
    "rate1_32": (32, lambda: []),
    "rate0_16": (16, lambda: list(range(16))),
    # above the register subtrees (nodes of 2048): F, G, COMBINE; ZeroR;
    # one leaf of each kind
    "bb2048": (2048, lambda: frozen_bits(2048, 1024, 0.0)),
    "zero_r2048": (2048, lambda: list(range(1024)) + [1024 + int(i) for i in
                                                      frozen_bits(1024, 512, 0.0)]),
    "rep2048": (2048, lambda: list(range(2047))),
    "spc2048": (2048, lambda: [0]),
    "rate1_2048": (2048, lambda: []),
    "rate0_2048": (2048, lambda: list(range(2048))),
}
FAMILIES = {"float32": torch.float32, "int8": torch.int8}


@pytest.fixture(scope="module")
def k3():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the CPU build of a kernel needs it")
    return _emu.load_on_cpu("fastssc_subtree")


@pytest.fixture(scope="module")
def k2():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the CPU build of a kernel needs it")
    return _emu.load_on_cpu("butterfly_encode")


def _kinds(sched):
    """(where, kind) of each op as the kernel runs it: "registers" for a
    node of at most 1024 positions (a register subtree), else "shared"."""
    names = ["F", "G", "ZERO_R", "COMBINE"]
    leaves = ["RATE0", "RATE1", "REP", "SPC"]
    out = set()
    for op, _, length, _, kind in sched.ops.tolist():
        leaf = op == fk.OP_LEAF
        where = "registers" if length <= 1024 else "shared"
        out.add((where, leaves[kind] if leaf else names[op]))
    return out


def _llrs(rng, dtype, span, n_batch):
    """Gaussian and integer LLRs [span, B] of the family's dtype."""
    if dtype == torch.float32:
        ints = rng.integers(-2, 3, (span, n_batch)).astype(np.float32)
        ints[ints == 0] *= rng.choice([-1.0, 1.0], int((ints == 0).sum()))  # -0.0 and +0.0
        gauss = (rng.standard_normal((span, n_batch)) * 2.0 + 0.5).astype(np.float32)
        # magnitudes far apart: a float sum in another order rounds to another sign
        order = rng.choice(np.float32([1e8, -1e8, 1.0, -0.5, 0.25, -3.0]), (span, n_batch))
        order[:, 0] = np.resize(np.float32([1e8, 1.0, -1e8, -0.5]), span)  # sums to -0.5 in order
        if n_batch > 1:  # -0.5 in order, +31 with its halves of 32 swapped
            order[:, 1] = np.resize(np.float32([1e8] + [1.0] * 31 + [-1e8, -0.5] + [0.0] * 30),
                                    span)
        return {"ints": torch.as_tensor(ints), "gauss": torch.as_tensor(gauss),
                "order": torch.as_tensor(order)}
    ints = rng.integers(-2, 3, (span, n_batch)).astype(np.int8)
    wide = np.clip(np.round(rng.standard_normal((span, n_batch)) * 40.0), -127, 127)
    wide[rng.random((span, n_batch)) < 0.15] = -128
    wide[rng.random((span, n_batch)) < 0.1] = 127
    wide[rng.random((span, n_batch)) < 0.1] = -127
    return {"ints": torch.as_tensor(ints), "wide": torch.as_tensor(wide.astype(np.int8))}


def test_codes_hold_every_op_kind():
    """The codes below run every op and leaf kind in registers and in
    shared memory (rate-0 leaves in registers only as right children)."""
    seen = set()
    for span, frozen in CODES.values():
        seen |= _kinds(fk.build_schedule(build_tree(span, frozen())))
    for where in ("registers", "shared"):
        for kind in ("F", "G", "ZERO_R", "COMBINE", "RATE0", "RATE1", "REP", "SPC"):
            assert (where, kind) in seen, (where, kind)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("code", CODES)
def test_fastssc_source_on_cpu(k3, code, family):
    span, frozen = CODES[code]
    sched = fk.build_schedule(build_tree(span, frozen()))
    dtype = FAMILIES[family]
    rng = np.random.default_rng(span * 7 + len(code))
    for n_batch in (1, 9) if span <= 512 else (1, 3):
        for kind, llr in _llrs(rng, dtype, span, n_batch).items():
            for root in (True, False):
                got = fk.launch(k3, sched, llr, root)
                want = fk.fastssc_subtree_plain(sched, llr, root)
                where = f"{code} {family} B={n_batch} {kind} root={root}"
                assert got.dtype == want.dtype and got.shape == want.shape, where
                assert torch.equal(got, want), where


@pytest.mark.parametrize("family", FAMILIES)
def test_fastssc_decoder_on_cpu_build(k3, family):
    """FastSSCDecoder at N = 256 with kernel_span 64: the glue above and
    K3's CPU build on every subtree (bipolar state out) decide as the
    plain version does."""
    n, dtype = 256, FAMILIES[family]
    frozen = frozen_bits(n, 128, 0.0)
    calls = []

    def on_cpu_build(sched, llr, root):
        calls.append(root)
        return fk.launch(k3, sched, llr, root)

    dec = FastSSCDecoder(n, frozen, dtype=dtype, kernel_span=64, device="cpu",
                         subtree_fn=on_cpu_build)
    plain = FastSSCDecoder(n, frozen, dtype=dtype, kernel_span=64, device="cpu",
                           subtree_fn=fk.fastssc_subtree_plain)
    rng = np.random.default_rng(3)
    llr = rng.standard_normal((9, n)) * 2.0 + 1.0
    x = torch.as_tensor(np.round(llr * 10) if dtype == torch.int8 else llr).to(dtype)
    assert torch.equal(dec.decode_to_codeword(x), plain.decode_to_codeword(x))
    assert len(calls) >= 2 and not any(calls)


def test_fastssc_source_refuses_spans(k3):
    fn = fk._bind(k3)
    assert fn(None, 0, None, None, 0, 1, 4096, 1, None) == -1
    assert fn(None, 0, None, None, 0, 1, 48, 1, None) == -1


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("n", [2, 4, 32, 64, 256, 1024, 2048])
def test_butterfly_source_on_cpu(k2, n, systematic):
    rng = np.random.default_rng(n + int(systematic))
    code_mask = torch.zeros(n, dtype=torch.uint8)
    code_mask[list(frozen_bits(n, n // 2, 0.0))] = 1
    random_mask = torch.as_tensor(rng.integers(0, 2, n).astype(np.uint8))
    for n_batch in (1, 3):
        for name, mask in (("code mask", code_mask), ("random mask", random_mask)):
            u = torch.as_tensor(rng.integers(0, 2, (n_batch, n)).astype(np.uint8))
            for frozen_zero in (False, True):
                x = u.masked_fill(mask.bool(), 0) if frozen_zero else u
                got = bk.launch(k2, x, mask, systematic)
                assert torch.equal(got, bk.butterfly_encode_plain(x, mask, systematic)), (
                    f"N={n} B={n_batch} {name} frozen positions zero: {frozen_zero}")
    buf = torch.zeros(3 * n + 1, dtype=torch.uint8)  # not 16-byte aligned
    x = buf[1:].view(3, n)
    x.copy_(torch.as_tensor(rng.integers(0, 2, (3, n)).astype(np.uint8)))
    assert x.data_ptr() % 16
    assert torch.equal(bk.launch(k2, x, code_mask, systematic),
                       bk.butterfly_encode_plain(x, code_mask, systematic))


def test_butterfly_source_refuses_lengths(k2):
    fn = bk._bind(k2)
    for n in (1, 48, 4096):
        assert fn(None, None, None, 1, n, 1, None) == -1
