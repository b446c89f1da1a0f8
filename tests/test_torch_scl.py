"""The plain version of the SCL subtree kernel K1 against the JAX package's
Pallas subtree kernel (interpret mode, bitplane on), call by call, plus
the prune order, the schedule and the wrapper's dispatch.

Tolerances: decision bits, perms and candidate ids must be equal;
metrics agree within rtol = atol = 1e-4, because the port sums in span
order and XLA may reassociate (as tests/test_scl_pallas.py states)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402
from polar_codes_tpu.ops import scl_kernel_bl as jkbl  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_scl_pallas.py test_all_leaf_kinds: every leaf kind below span 32
ALL_KINDS_FROZEN = sorted(set(
    list(range(16)) + [16, 17, 18, 20, 24] + [32, 33, 34, 35, 36, 37, 38] + [48]))


def _jax_calls(jdec, span, batch):
    """{(offset, length, w_in): (w_out, call)} of the JAX hybrid decode's
    subtree kernels, found by tracing it once (nothing runs)."""
    run = jkbl.build_bl_hybrid_decode_paths(
        jdec, batch_tile=batch, kernel_span=span, interpret=True, bitplane=True)
    jax.eval_shape(run.raw_packed,
                   jax.ShapeDtypeStruct((batch, jdec.block_length), jnp.float32))
    return {(n.offset, n.length, w_in): (w_out, call)
            for n, w_in, w_out, call in run.subtree_info}


def _check_calls(n_len, frozen, list_size, span, batch, seed, **tree):
    jdec = JaxSCLDecoder(n_len, frozen, list_size=list_size, **tree)
    jcalls = _jax_calls(jdec, span, batch)
    calls = []

    def record(sched, llr, metrics):
        out = kbl.scl_subtree_plain(sched, llr, metrics)
        calls.append((sched, llr, metrics, out))
        return out

    dec = SCLDecoder(n_len, frozen, list_size=list_size, kernel_span=span,
                     subtree_fn=record, device="cpu", **tree)
    llr = np.random.default_rng(seed).normal(0, 2, (batch, n_len)).astype(np.float32)
    dec.decode_packed(torch.as_tensor(llr))
    assert len(calls) == len(jcalls) >= 2
    for sched, x, m, (bits, perm, met) in calls:
        w_out, jcall = jcalls[(sched.node.offset, sched.node.length, sched.w_in)]
        assert sched.w_out == w_out
        jbits, jperm, jmet = jcall(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_allclose(met.numpy(), np.asarray(jmet), **TOL)
    return calls


@pytest.mark.parametrize("list_size,enum_span,max_enum_k", [(4, 4, 2), (8, 8, 3)])
def test_plain_subtree_matches_jax_kernel_all_leaf_kinds(list_size, enum_span,
                                                         max_enum_k):
    """tests/test_scl_pallas.py's all-leaf-kinds code at L = 8 (ENUM span 8,
    k 3, which turns its REP leaves into ENUM) and at L = 4 with ENUM span 4,
    k 2, which keeps one REP leaf beside every other kind."""
    calls = _check_calls(64, ALL_KINDS_FROZEN, list_size, 32, 16, list_size,
                         enum_span=enum_span, max_enum_k=max_enum_k)
    kinds = {leaf.kind.value for c in calls for leaf in c[0].node.leaves()}
    assert kinds >= {"rate0", "rate1", "spc", "enum"}
    assert list_size == 8 or "rep" in kinds
    assert {c[0].w_in for c in calls} == {1, list_size}  # widening + steady


@pytest.mark.slow
def test_plain_subtree_matches_jax_kernel_n256():
    _check_calls(256, frozen_bits(256, 128, 0.0), 8, 64, 16, 3)


def _reference_order(flat):
    """Top-L codes of [total, B] by (value desc, code asc), via numpy."""
    total = flat.shape[0]
    return np.stack([np.lexsort((np.arange(total), -flat[:, b]))
                     for b in range(flat.shape[1])], axis=1)


def test_prune_order_with_forced_ties():
    """The TestPruneEquivalence cases (tests/test_scl_pallas.py): exact ties
    across candidates, paths and a zero-delta block."""
    rng = np.random.default_rng(42)
    checked = 0
    for n_list in (2, 4, 8, 16, 32):
        plain = kbl._Plain(n_list)
        for n_cand in (2, 3, 4, 8, 16):
            for width in sorted({1, 2, max(n_list // 2, 1), n_list}):
                n_b = 8
                metrics = rng.normal(0, 5, (width, n_b)).astype(np.float32)
                deltas = -np.abs(rng.normal(0, 3, (n_cand, width, n_b))).astype(np.float32)
                deltas[0] = deltas[-1]
                metrics[0] = metrics[-1]
                deltas[:, :, :4] = 0.0
                m, src, cand = plain.prune(torch.as_tensor(metrics), torch.as_tensor(deltas))
                flat = (metrics[None] + deltas).transpose(1, 0, 2).reshape(-1, n_b)
                if width * n_cand <= n_list:  # widening: every candidate, l-major
                    codes = np.broadcast_to(np.arange(width * n_cand)[:, None], flat.shape)
                else:
                    codes = _reference_order(flat)[:n_list]
                np.testing.assert_array_equal(src.numpy(), codes // n_cand)
                np.testing.assert_array_equal(cand.numpy(), codes % n_cand)
                np.testing.assert_array_equal(m.numpy(), np.take_along_axis(flat, codes, 0))
                checked += 1
    assert checked > 60


def test_prune_matches_jax_emitter():
    """Against the JAX kernel's own iterative prune, on tied inputs (its
    bitonic merge, the L >= 8 default, meets the plain prune in the L = 8
    call-by-call test above)."""
    class _Dec:
        _int8 = False
        list_size = 8

    emitter = jkbl._BlEmitter(_Dec(), merge_prune=False)
    rng = np.random.default_rng(3)
    for n_cand, width in ((8, 8), (16, 2)):
        metrics = rng.normal(0, 5, (width, 8)).astype(np.float32)
        deltas = -np.abs(rng.normal(0, 3, (n_cand, width, 8))).astype(np.float32)
        deltas[0] = deltas[-1]
        deltas[:, :, :4] = 0.0
        jm, js, jc = jax.jit(emitter._prune)(jnp.asarray(metrics), jnp.asarray(deltas))
        m, s, c = kbl._Plain(8).prune(torch.as_tensor(metrics), torch.as_tensor(deltas))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_schedule_widths_match_jax():
    n_len = 1024
    frozen = frozen_bits(n_len, 512, 0.0)
    jdec = JaxSCLDecoder(n_len, frozen, list_size=8)
    dec = SCLDecoder(n_len, frozen, list_size=8, device="cpu")
    assert dec.kernel_span == 512
    jroot = jdec.tree
    for node, jnode in ((dec.tree.left, jroot.left), (dec.tree.right, jroot.right)):
        for w_in in (1, 2, 8):
            sched = dec.schedule(node, w_in)
            assert sched.w_out == jkbl._static_width(jdec, jnode, w_in)
            assert sched is dec.schedule(node, w_in)  # cached
            leaves = [op for op in sched.ops if op[0] == kbl.OP_LEAF]
            assert len(leaves) == len(node.leaves())
            assert sched.ops[-1][0] == kbl.OP_COMBINE and sched.levels <= kbl.MAX_LEVELS


def test_take_packed_and_bipolar():
    rng = np.random.default_rng(11)
    w, span, n_b = 8, 16, 8
    b01 = rng.integers(0, 2, (w, span, n_b)).astype(np.int32)
    word = kbl.pack01(torch.as_tensor(b01))
    np.testing.assert_array_equal(
        word.numpy(), np.asarray(jkbl._BlEmitter._pack01(jnp.asarray(b01))))
    src = rng.integers(0, w, (w, n_b)).astype(np.int32)
    got = kbl.take_packed(word, torch.as_tensor(src), w)
    want = jkbl._BlEmitter._take_packed(jnp.asarray(word.numpy()), jnp.asarray(src), w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(kbl.packed_bipolar(word, w).numpy(), 1.0 - 2.0 * b01)


def test_list_size_limits():
    frozen = frozen_bits(64, 32, 0.0)
    sc = SCLDecoder(64, frozen, list_size=1, device="cpu")
    assert sc.tree.kind.value == "branch" and sc._sc is not None  # L = 1: Fast-SSC
    assert SCLDecoder(64, frozen, list_size=32, device="cpu").words == 1
    assert SCLDecoder(64, frozen, list_size=64, device="cpu").words == 2  # two packed words
    with pytest.raises(ValueError, match="at least one path"):
        SCLDecoder(64, frozen, list_size=0, device="cpu")


def test_subtree_kernel_never_falls_back(monkeypatch):
    """A CUDA tensor reaches the kernel or raises; it never takes the
    plain version. Here there is no card and no nvcc, so it raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dec = SCLDecoder(64, frozen_bits(64, 32, 0.0), list_size=8, kernel_span=32,
                     device="cpu")
    sched = dec.schedule(dec.tree.left, 1)
    with FakeTensorMode():
        llr = torch.empty((1, 32, 16), device="cuda")
        short = torch.empty((1, 16, 16), device="cuda")
        met = torch.empty((16, 1), device="cuda")
    called = []
    monkeypatch.setattr(kbl, "scl_subtree_plain", lambda *a: called.append(a))
    before = dict(kbl.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        kbl.scl_subtree(sched, llr, met)
    with pytest.raises(ValueError, match="expects llr"):
        kbl.scl_subtree(sched, short, met)
    assert not called and kbl.LAUNCHES == before
