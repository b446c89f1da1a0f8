"""The port's Fast-SSC decoder and its kernel K3's plain version against the
JAX package: the char f/g pair on all integer pairs, the tree with
`allowed`, the decoder against the JAX Pallas kernel in interpret mode
(root call and glue, float and int8), decode() against the JAX XLA
decoder, the C++ reference's SC decisions, and SCL at L = 1.

Tolerances: decisions are equal; the L = 1 path metric, a float sum taken
in another order, agrees within rtol = atol = 1e-4."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.fastssc import FastSSCDecoder as JaxFastSSC  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402
from polar_codes_tpu.models.tree import NodeKind as JaxKind  # noqa: E402
from polar_codes_tpu.models.tree import build_tree as jax_build_tree  # noqa: E402
from polar_codes_tpu.ops import fg as jfg  # noqa: E402
from polar_codes_tpu.ops.fastssc_kernel import build_fs_hybrid_decode  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.models.tree import NodeKind, build_tree  # noqa: E402
from polar_codes_torch.ops import fastssc_kernel as fk  # noqa: E402
from polar_codes_torch.ops import fg  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DTYPES = {"float32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}


def _llr(rng, dtype, shape):
    """Continuous LLRs, or int8 LLRs in [-127, 127] (the quantiser's range)."""
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.normal(0, 2, shape).astype(np.float32)


def test_char_f_g_equal_all_pairs():
    v = np.arange(-127, 128)
    a, b = (x.ravel() for x in np.meshgrid(v, v))
    for ta, tb, ja, jb in (
        (torch.as_tensor(a, dtype=torch.int8), torch.as_tensor(b, dtype=torch.int8),
         jnp.asarray(a, jnp.int8), jnp.asarray(b, jnp.int8)),
        (torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(b, dtype=torch.float32),
         jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)),
    ):
        i8 = ta.dtype == torch.int8
        f, g = (fg.f_minsum_i8, fg.g_update_i8) if i8 else (fg.f_minsum_sat, fg.g_update_sat)
        jf, jg = (jfg.f_minsum_i8, jfg.g_update_i8) if i8 else (jfg.f_minsum_sat, jfg.g_update_sat)
        np.testing.assert_array_equal(f(ta, tb).numpy(), np.asarray(jf(ja, jb)))
        for sign in (1, -1):
            left = torch.full_like(ta, sign)
            got = g(ta, tb, left).numpy()
            np.testing.assert_array_equal(got, np.asarray(jg(ja, jb, jnp.full_like(ja, sign))))
            assert got.min() >= -127 and got.max() <= 127


def _nodes(node):
    out = [(node.kind.value, node.offset, node.length)]
    if node.left is not None:
        out += _nodes(node.left) + _nodes(node.right)
    return out


@pytest.mark.parametrize("n,k", [(64, 40), (256, 128), (512, 300)])
def test_tree_with_allowed_equal(n, k):
    frozen = frozen_bits(n, k, 0.0)
    for allowed, jallowed in (
        (frozenset({NodeKind.RATE0, NodeKind.RATE1}), frozenset({JaxKind.RATE0, JaxKind.RATE1})),
        (frozenset({NodeKind.RATE0, NodeKind.SPC}), frozenset({JaxKind.RATE0, JaxKind.SPC})),
    ):
        assert _nodes(build_tree(n, frozen, allowed=allowed)) == _nodes(
            jax_build_tree(n, frozen, allowed=jallowed))
    assert _nodes(build_tree(n, frozen)) == _nodes(jax_build_tree(n, frozen))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("n,k,span", [(256, 128, 256), (512, 300, 64)])
def test_decoder_matches_jax_kernel(n, k, span, dtype, rng):
    """tests/test_fastssc.py TestPallasFastSSCKernel's shapes, odd batch of
    37: one root call (span N), and glue above span 64 with kernel_bits
    calls below it."""
    frozen = frozen_bits(n, k, 0.0)
    tdt, jdt = DTYPES[dtype]
    jdec = JaxFastSSC(n, frozen, systematic=True, dtype=jdt, backend="pallas")
    run = build_fs_hybrid_decode(jdec, batch_tile=16, kernel_span=span, interpret=True)
    llr = _llr(rng, dtype, (37, n))
    calls = []

    def record(sched, x, root):
        calls.append(root)
        return fk.fastssc_subtree_plain(sched, x, root)

    dec = FastSSCDecoder(n, frozen, dtype=tdt, kernel_span=span, device="cpu",
                         subtree_fn=record)
    got = dec.decode_to_codeword(torch.as_tensor(llr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(run(jnp.asarray(llr))))
    assert calls == [True] if span == n else (len(calls) > 2 and not any(calls))


@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_decode_matches_jax_xla(systematic, dtype, rng):
    n, k = 128, 72
    frozen = frozen_bits(n, k, 0.0)
    tdt, jdt = DTYPES[dtype]
    dec = FastSSCDecoder(n, frozen, systematic=systematic, detector=tdet.CRC8(),
                         dtype=tdt, device="cpu")
    jdec = JaxFastSSC(n, frozen, systematic=systematic, detector=jdet.CRC8(), dtype=jdt)
    llr = _llr(rng, dtype, (24, n))
    llr = (llr // 4 + 20).astype(llr.dtype)  # a bias towards bit 0 lets some CRCs pass
    got = dec.decode(torch.as_tensor(llr))
    want = jax.jit(jdec.decode)(jnp.asarray(llr))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpp_reference_sc_decisions():
    """tests/test_crosscheck.py: the C++ reference's Fast-SSC decisions on
    its noisy LLRs, (256, 128) CRC8, bit-exact on every block."""
    llr = np.fromfile(os.path.join(DATA, "cc_llr.bin"), dtype=np.float32).reshape(64, 256)
    want = np.unpackbits(np.fromfile(os.path.join(DATA, "cc_sc_out.bin"), np.uint8))
    dec = FastSSCDecoder(256, frozen_bits(256, 128, 0.0, "BB"), detector=tdet.CRC8(),
                         device="cpu")
    got, _, _ = dec.decode(torch.as_tensor(llr))
    np.testing.assert_array_equal(got.numpy(), want.reshape(64, 128))


@pytest.mark.parametrize("systematic", [True, False])
def test_scl_list1_matches_jax(systematic, rng):
    n, k = 128, 72
    frozen = frozen_bits(n, k, 0.0)
    dec = SCLDecoder(n, frozen, list_size=1, systematic=systematic,
                     detector=tdet.CRC8(), device="cpu")
    jdec = JaxSCLDecoder(n, frozen, list_size=1, systematic=systematic,
                         detector=jdet.CRC8())
    assert dec.enum_span == 0 and dec.kernel_span == 128
    llr = rng.normal(1.5, 1.5, (24, n)).astype(np.float32)
    for a, b in zip(dec.decode(torch.as_tensor(llr)), jax.jit(jdec.decode)(jnp.asarray(llr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cw, m, act = dec.decode_paths(torch.as_tensor(llr))
    jcw, jm, jact = jax.jit(jdec.decode_paths)(jnp.asarray(llr))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))


def test_schedule_walks_the_tree():
    dec = FastSSCDecoder(512, frozen_bits(512, 300, 0.0), device="cpu")
    sched = dec.schedule(dec.tree)
    assert sched is dec.schedule(dec.tree)  # cached
    ops = sched.ops
    leaves = dec.tree.leaves()
    zero_r = [op for op in ops if op[0] == fk.OP_ZERO_R]
    n_branch = len(leaves) - 1
    assert (ops[:, 0] == fk.OP_LEAF).sum() == len(leaves) - len(zero_r)
    assert (ops[:, 0] == fk.OP_COMBINE).sum() == n_branch
    assert (ops[:, 0] == fk.OP_F).sum() == (ops[:, 0] == fk.OP_G).sum() == n_branch - len(zero_r)
    assert ops[-1][0] == fk.OP_COMBINE and ops[:, 1].max() < 10
    assert {NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC} == {
        leaf.kind for leaf in leaves}


def test_leaf_decision_rules_and_spc_ties():
    """Float decides -0.0 as 1 (sign bit), char decides 0 as 0; an SPC leaf
    with odd parity flips the lowest index among equal minimum
    magnitudes; char f saturates at an input of -128; the float REP sum
    runs in span order."""
    rate1 = build_tree(4, [])
    x = torch.tensor([[-0.0], [0.0], [-1.0], [2.0]])
    out = fk.fastssc_subtree_plain(fk.build_schedule(rate1), x, True)
    np.testing.assert_array_equal(out[:, 0].numpy(), [1, 0, 1, 0])
    xi = torch.tensor([[0], [0], [-1], [2]], dtype=torch.int8)
    out = fk.fastssc_subtree_plain(fk.build_schedule(rate1), xi, True)
    np.testing.assert_array_equal(out[:, 0].numpy(), [0, 0, 1, 0])

    spc = build_tree(8, [0])
    assert spc.kind == NodeKind.SPC
    llr = np.array([[5, 3, -3, 7, 3, 9, 3, 4],       # parity odd: flip index 1
                    [5, 3, 3, 7, 3, 9, 3, 4],        # even: keep
                    [-2, 2, -2, 2, -2, 2, 2, 2]],    # odd: flip index 0
                   dtype=np.int8)
    want = np.asarray(JaxFastSSC(8, [0], dtype=jnp.int8).decode_to_codeword(jnp.asarray(llr)))
    for dt in (torch.int8, torch.float32):
        got = fk.fastssc_subtree_plain(fk.build_schedule(spc),
                                       torch.as_tensor(llr.T.copy()).to(dt), True)
        np.testing.assert_array_equal(got.T.numpy(), want)
    np.testing.assert_array_equal(want[0], [0, 1, 1, 0, 0, 0, 0, 0])

    lo = torch.tensor([-128, -128, -128, 127], dtype=torch.int8)
    hi = torch.tensor([-128, 5, -1, -128], dtype=torch.int8)
    np.testing.assert_array_equal(fk._Char.f(lo, hi).numpy(), [127, -5, 1, -127])

    vals = torch.tensor([[1e8], [1.0], [-1e8], [-0.5]])
    acc = np.float32(0)
    for v in vals[:, 0].numpy():
        acc = np.float32(acc + v)
    assert fk._Float.rep_sum(vals)[0].item() == acc == -0.5


def test_fastssc_kernel_never_falls_back(monkeypatch):
    """A CUDA tensor reaches the kernel or raises; it never takes the plain
    version. Here there is no card and no nvcc, so it raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dec = FastSSCDecoder(64, frozen_bits(64, 32, 0.0), device="cpu")
    sched = dec.schedule(dec.tree)
    with FakeTensorMode():
        llr = torch.empty((64, 16), device="cuda")
        short = torch.empty((32, 16), device="cuda")
        wrong = torch.empty((64, 16), dtype=torch.float16, device="cuda")
    called = []
    monkeypatch.setattr(fk, "fastssc_subtree_plain", lambda *a: called.append(a))
    before = dict(fk.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        fk.fastssc_subtree(sched, llr, True)
    with pytest.raises(ValueError, match="expects llr"):
        fk.fastssc_subtree(sched, short, True)
    with pytest.raises(ValueError, match="float32 or int8"):
        fk.fastssc_subtree(sched, wrong, False)
    assert not called and fk.LAUNCHES == before


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_full_width_matches_jax_xla(dtype, rng):
    n, k = 1024, 512
    frozen = frozen_bits(n, k, 0.0)
    tdt, jdt = DTYPES[dtype]
    llr = _llr(rng, dtype, (32, n))
    got = FastSSCDecoder(n, frozen, dtype=tdt, device="cpu").decode_to_codeword(
        torch.as_tensor(llr))
    want = JaxFastSSC(n, frozen, dtype=jdt).decode_to_codeword(jnp.asarray(llr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
